"""parallax-tpu-torch command line interface (port of
``parallax_tpu/cli.py``'s ``serve``, ``generate``, ``run``, ``join``,
``chat``, ``chat-host`` and ``lora-merge``).

    python -m parallax_tpu_torch serve --model-path DIR [--port 8000]
    python -m parallax_tpu_torch generate --model-path DIR --prompt "Hi"
    python -m parallax_tpu_torch run --model-name DIR --min-nodes 2 \
        [--port 3001] [--routing cache_aware]
    python -m parallax_tpu_torch join --scheduler-addr HOST:3002 \
        --model-path DIR
    python -m parallax_tpu_torch join --model-path DIR --start-layer 0 \
        --end-layer 14 --peers HOST:PORT [--port 7000]
    python -m parallax_tpu_torch chat [--base-url http://127.0.0.1:8000]
    python -m parallax_tpu_torch chat-host --head HOST:PORT [--port 8000]
    python -m parallax_tpu_torch lora-merge --model-path DIR \
        --adapter-path PEFT_DIR --out-dir OUT

The flags keep the JAX package's names and defaults, plus ``--device``
(default ``cuda:0``; ``--device cpu`` runs the plain PyTorch path) and the
``--host`` the HTTP entry points bind. A flag whose feature the port does
not run yet exits with code 2 and names the ROADMAP queue 1 item that
ports it; so do the JAX CLI's other subcommands. ``run`` touches no
device; its scheduler's RPC listens on ``--port + 1``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

# The JAX CLI's subcommands that wait for later slices -> ROADMAP item.
UNPORTED_COMMANDS = {"bench": 5}


def _add_engine_flags(p: argparse.ArgumentParser) -> None:
    """Flags ``serve`` and ``generate`` share."""
    p.add_argument("--model-path", required=True)
    p.add_argument("--device", default="cuda:0",
                   help="torch device to run on (default cuda:0; 'cpu' "
                        "runs the plain PyTorch path)")
    p.add_argument("--kv-dtype", choices=["bfloat16", "float32"],
                   default="bfloat16")
    p.add_argument("--tp-size", type=int, default=0,
                   help="0 = all local devices (one card: unsharded)")
    p.add_argument("--quantization", choices=["int8", "int4"], default=None,
                   help="weight-only quantize an fp checkpoint on load")
    p.add_argument("--lora-path", default=None,
                   help="PEFT LoRA adapter directory to merge at load")
    p.add_argument("--decode-lookahead", type=int, default=None,
                   help="decode tokens per host visit (default: adaptive "
                        "up to 8; 1 = off)")
    p.add_argument("--decode-fused", action=argparse.BooleanOptionalAction,
                   default=None,
                   help="fused decode kernels (default: on on a CUDA "
                        "device; --no-decode-fused runs the split path)")
    p.add_argument("--prefill-fused", action=argparse.BooleanOptionalAction,
                   default=None,
                   help="fused prefill kernels (default: on on a CUDA "
                        "device)")
    p.add_argument("--compilation-cache-dir", default=None,
                   help="where the kernel and native libraries build and "
                        "load (default: $PARALLAX_TPU_COMPILE_CACHE, else "
                        "the package's _build/; 'off' builds privately)")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="parallax-tpu-torch",
        description="parallax serving on PyTorch + CUDA (NVIDIA Hopper)",
    )
    sub = p.add_subparsers(dest="command")

    serve = sub.add_parser("serve", help="serve a model on this host")
    _add_engine_flags(serve)
    serve.add_argument("--start-layer", type=int, default=None)
    serve.add_argument("--end-layer", type=int, default=None)
    serve.add_argument("--port", type=int, default=8000)
    serve.add_argument("--host", default="0.0.0.0")
    serve.add_argument("--page-size", type=int, default=64)
    serve.add_argument("--max-batch-size", type=int, default=64)
    serve.add_argument("--max-model-len", type=int, default=8192)
    serve.add_argument("--kv-utilization", type=float, default=0.9)
    serve.add_argument("--max-num-tokens-per-batch", type=int, default=2048)
    serve.add_argument("--prefill-chunk-size", type=int, default=1024)
    serve.add_argument("--no-prefix-cache", action="store_true")
    serve.add_argument("--host-cache-bytes", type=int, default=None,
                       help="host-DRAM KV tier budget in bytes (unset: "
                            "half of available RAM on a card, off on the "
                            "CPU; 0: off)")
    serve.add_argument("--linear-prefix-slots", type=int, default=32)
    serve.add_argument("--lora-adapters", default=None,
                       help="per-request adapters: name=peft_dir[,...]")
    serve.add_argument("--decode-pipeline", type=int, default=1,
                       help="chained k-token decode windows per host "
                            "round (1 = off)")
    serve.add_argument("--prefill-chunk-skip",
                       action=argparse.BooleanOptionalAction, default=True)
    serve.add_argument("--prefill-seq-parallel", action="store_true")
    serve.add_argument("--speculative-tokens", type=int, default=0)
    serve.add_argument("--speculative-ngram", type=int, default=3)
    serve.add_argument("--draft-model-path", default=None)
    serve.add_argument("--sp-size", type=int, default=0)
    serve.add_argument("--sp-threshold", type=int, default=2048)
    serve.add_argument("--wire-dtype", default=None,
                       choices=["bfloat16", "bf16", "fp8", "float8_e4m3fn"])
    serve.add_argument("--trace-sample-rate", type=float, default=0.0)
    serve.add_argument("--slow-request-ms", type=float, default=30000.0)
    serve.add_argument("--watchdog", action="store_true")
    serve.add_argument("--slo", default=None)
    serve.add_argument("--slo-window-s", type=float, default=300.0)
    serve.add_argument("--qos", default=None)
    serve.add_argument("--lora-max-adapters", type=int, default=0)

    gen = sub.add_parser("generate",
                         help="offline one-shot generation, no server")
    _add_engine_flags(gen)
    gen.add_argument("--prompt", default="Hi")
    gen.add_argument("--max-tokens", type=int, default=256)
    gen.add_argument("--temperature", type=float, default=0.0)
    gen.add_argument("--top-k", type=int, default=-1)
    gen.add_argument("--top-p", type=float, default=1.0)

    run = sub.add_parser("run", help="launch the scheduler + frontend")
    _add_run_flags(run)

    join = sub.add_parser("join", help="join a swarm as a worker")
    _add_join_flags(join)

    chat = sub.add_parser("chat", help="interactive chat against a server")
    chat.add_argument("--base-url", default="http://127.0.0.1:8000")
    chat.add_argument("--max-tokens", type=int, default=512)
    chat.add_argument("--temperature", type=float, default=0.7)

    chost = sub.add_parser(
        "chat-host",
        help="OpenAI API host on a non-worker machine, proxying to a "
             "scheduler-less swarm's head worker over RPC")
    chost.add_argument("--head", required=True,
                       help="head worker transport address (host:port)")
    chost.add_argument("--port", type=int, default=8000)
    chost.add_argument("--host", default="0.0.0.0")
    chost.add_argument("--model-path", default=None,
                       help="checkpoint dir for the tokenizer")
    chost.add_argument("--model-name", default=None)

    merge = sub.add_parser(
        "lora-merge",
        help="fuse a PEFT LoRA adapter into a checkpoint (a new directory)")
    merge.add_argument("--model-path", required=True)
    merge.add_argument("--adapter-path", required=True)
    merge.add_argument("--out-dir", required=True)

    for name in UNPORTED_COMMANDS:
        sub.add_parser(name, help="not ported yet", add_help=False)
    return p


def _add_run_flags(run: argparse.ArgumentParser) -> None:
    """The JAX ``run``'s flags, plus ``--host``."""
    run.add_argument("--model-name", required=True,
                     help="checkpoint directory (its config and tokenizer) "
                          "or a preset name")
    run.add_argument("--min-nodes", type=int, default=1)
    run.add_argument("--port", type=int, default=3001,
                     help="HTTP port; the scheduler's RPC listens on "
                          "port + 1 (0: both on free ports, logged)")
    run.add_argument("--host", default="0.0.0.0")
    run.add_argument("--routing", default="rr",
                     choices=["rr", "dp", "random", "cache_aware"],
                     help="request routing strategy: rr round-robins "
                          "registered pipelines; dp shortest-latency over "
                          "announced layer ranges; random latency-weighted; "
                          "cache_aware scores pipelines by predicted "
                          "prefix-cache hit plus load")
    run.add_argument("--routing-alpha", type=float, default=1.0,
                     help="cache_aware: cost per predicted UNCACHED prompt "
                          "token")
    run.add_argument("--routing-beta", type=float, default=256.0,
                     help="cache_aware: cost per in-flight request on the "
                          "head")
    run.add_argument("--routing-imbalance", type=int, default=8,
                     help="cache_aware: in-flight spread past which "
                          "dispatch falls back to least-loaded")
    run.add_argument("--routing-gamma", type=float, default=0.0)
    run.add_argument("--relay-token", default=None,
                     help="swarm secret every relay registration of a NAT'd "
                          "worker (join --relay) must present")
    run.add_argument("--slo", default=None)
    run.add_argument("--slo-window-s", type=float, default=300.0)
    run.add_argument("--qos", default=None)
    run.add_argument(
        "--scheduler-standby", default=None,
        help="scheduler HA (docs/ha.md): comma-separated warm-standby "
             "scheduler RPC addresses. The primary streams its state "
             "journal to them and advertises the list to every worker "
             "and client, so scheduler RPCs fail over to a promoted "
             "standby; omit to run without HA (a scheduler crash "
             "stalls routing until restart)",
    )
    run.add_argument(
        "--standby-of", default=None,
        help="scheduler HA (docs/ha.md): run THIS process as a warm "
             "standby mirroring the given primary scheduler RPC "
             "address; it serves read-only lookups, tails the "
             "snapshot+journal stream, and promotes itself (bumping "
             "the scheduler epoch) when the primary's lease expires",
    )
    run.add_argument(
        "--ha-lease-s", type=float, default=6.0,
        help="scheduler HA: seconds without journal progress from the "
             "primary before a standby promotes itself (docs/ha.md)",
    )


def _add_join_flags(join: argparse.ArgumentParser) -> None:
    """The JAX ``join``'s flags, plus ``--device``."""
    join.add_argument("--scheduler-addr", default=None,
                      help="scheduler RPC address (run's --port + 1); omit "
                           "it for scheduler-less mode, which needs --peers "
                           "and --start-layer / --end-layer")
    join.add_argument("--peers", default=None,
                      help="comma-separated worker addresses to gossip "
                           "block announcements with")
    join.add_argument(
        "--scheduler-standby", default=None,
        help="scheduler HA (docs/ha.md): comma-separated warm-standby "
             "scheduler addresses to fail over to when the primary "
             "dies (the primary also advertises its list through "
             "allocations/heartbeat replies, so this seed is optional "
             "when workers join before any failover)",
    )
    join.add_argument("--start-layer", type=int, default=None,
                      help="this worker's first layer; blocks chain only "
                           "at EXACT boundaries: every worker's end layer "
                           "must equal the next worker's start layer")
    join.add_argument("--end-layer", type=int, default=None,
                      help="one past the last layer")
    join.add_argument("--model-path", default=None)
    join.add_argument("--device", default="cuda:0",
                      help="torch device to run on (default cuda:0; 'cpu' "
                           "runs the plain PyTorch path)")
    join.add_argument("--port", type=int, default=0)
    join.add_argument("--refit-cache-dir", default=None,
                      help="keep the newest three fetched weight-refit "
                           "versions here; a restart restores the newest "
                           "for its layer range")
    join.add_argument("--advertise-addr", default=None,
                      help="reachable host/IP peers dial for pp-forwards "
                           "(default: the host's routed address; pass "
                           "127.0.0.1 for a swarm on one host)")
    join.add_argument("--relay", action="store_true",
                      help="behind a NAT: accept no dials, keep a reverse "
                           "connection at the scheduler's relay (needs "
                           "--scheduler-addr)")
    join.add_argument("--relay-token", default=None,
                      help="the swarm's relay secret (run --relay-token)")
    join.add_argument(
        "--role", default=None, choices=["prefill", "decode", "mixed"],
        help="phase specialization for disaggregated serving: 'prefill' "
             "computes prompts and hands finished requests to the decode "
             "pool over the KV-transfer lane; 'decode' runs the decode "
             "batches prompts never interrupt; default 'mixed' serves both "
             "phases (no handoffs). Pipelines stay role-homogeneous")
    join.add_argument(
        "--kv-transfer-chunk-bytes", type=int, default=None,
        help="target payload bytes per layer-chunked KV_TRANSFER frame on "
             "the handoff lane (default 4 MiB): smaller frames overlap the "
             "transfer more, larger frames amortize framing")
    join.add_argument("--lora-adapters", default=None)
    join.add_argument("--sp-size", type=int, default=0)
    join.add_argument("--host-cache-bytes", type=int, default=None,
                      help="host-DRAM KV tier budget in bytes (unset: "
                           "half of available RAM on a card, off on the "
                           "CPU; 0: off)")
    join.add_argument("--sp-threshold", type=int, default=2048)
    join.add_argument("--wire-dtype", default=None,
                      choices=["bfloat16", "bf16", "fp8", "float8_e4m3fn"],
                      help="activation wire format of this worker's "
                           "outbound links (default: native precision, "
                           "bit-identical streams); negotiated per link")
    join.add_argument("--trace-sample-rate", type=float, default=0.0)
    join.add_argument("--slow-request-ms", type=float, default=30000.0)
    join.add_argument("--decode-lookahead", type=int, default=None,
                      help="decode tokens per host visit when this worker "
                           "serves a full single stage (default: adaptive "
                           "up to 8; 1 = off)")
    join.add_argument("--speculative-tokens", type=int, default=0)
    join.add_argument("--speculative-ngram", type=int, default=3)
    join.add_argument("--decode-pipeline", type=int, default=1)
    join.add_argument("--decode-fused", action=argparse.BooleanOptionalAction,
                      default=None,
                      help="fused decode kernels (default: on on a CUDA "
                           "device)")
    join.add_argument("--prefill-fused",
                      action=argparse.BooleanOptionalAction, default=None,
                      help="fused prefill kernels (default: on on a CUDA "
                           "device)")
    join.add_argument("--prefill-chunk-skip",
                      action=argparse.BooleanOptionalAction, default=True)
    join.add_argument("--compilation-cache-dir", default=None,
                      help="as serve's")
    join.add_argument("--watchdog", action="store_true")
    join.add_argument("--watchdog-degraded-s", type=float, default=5.0)
    join.add_argument("--watchdog-stalled-s", type=float, default=15.0)
    join.add_argument("--qos", default=None)
    join.add_argument("--lora-max-adapters", type=int, default=0)


def _hub_path(model_path: str) -> str:
    return (f"--model-path {model_path} (not a local directory: a hub "
            "download)")


def unported_join_flags(args) -> list[tuple[str, int | str | None]]:
    """``join``'s flags whose feature the port does not run, each with the
    ROADMAP queue 1 item that ports it (None: no item does)."""
    refused = []
    for on, flag, item in (
        (args.model_path is not None and not os.path.isdir(args.model_path),
         _hub_path(args.model_path), None),
        (args.sp_size > 1, f"--sp-size {args.sp_size}", 10),
    ):
        if on:
            refused.append((flag, item))
    return refused


def unported_flags(args) -> list[tuple[str, int | str | None]]:
    """The flags of ``args`` whose feature the port does not run, each
    with the ROADMAP queue 1 item that ports it (None: no item does; the
    port downloads no checkpoint)."""
    if args.command == "join":
        return unported_join_flags(args)
    if args.command in ("run", "chat", "chat-host", "lora-merge"):
        return []
    refused = []

    def refuse(on: bool, flag: str, item: int | str) -> None:
        if on:
            refused.append((flag, item))

    refuse(not os.path.isdir(args.model_path), _hub_path(args.model_path),
           None)
    refuse(args.tp_size > 1, f"--tp-size {args.tp_size}", 10)
    if args.command != "serve":
        return refused
    refuse(args.sp_size > 1, f"--sp-size {args.sp_size}", 10)
    refuse(args.prefill_seq_parallel, "--prefill-seq-parallel", 10)
    return refused


def _usage(chunk: dict | None) -> dict | None:
    usage = (chunk or {}).get("usage")
    return usage if isinstance(usage, dict) else None


def chat_main(args, input_fn=input) -> int:
    """Interactive streaming chat REPL against an OpenAI endpoint
    (reference ``parallax chat``; the JAX package's ``chat_main``), on the
    standard library. ``/quit`` exits, ``/clear`` resets the history;
    each turn prints its token count, rate and TTFT."""
    import urllib.request

    history: list[dict] = []
    print(f"chatting with {args.base_url} — /quit to exit, /clear to reset")
    while True:
        try:
            user = input_fn("you> ").strip()
        except (EOFError, KeyboardInterrupt):
            print()
            return 0
        if not user:
            continue
        if user == "/quit":
            return 0
        if user == "/clear":
            history.clear()
            continue
        history.append({"role": "user", "content": user})
        payload = json.dumps({
            "model": "parallax-tpu",
            "messages": history,
            "max_tokens": args.max_tokens,
            "temperature": args.temperature,
            "stream": True,
        }).encode()
        req = urllib.request.Request(
            f"{args.base_url}/v1/chat/completions", data=payload,
            headers={"Content-Type": "application/json"},
        )
        reply = []
        try:
            t0 = time.monotonic()
            t_first = t_last = None
            final = None
            with urllib.request.urlopen(req, timeout=600) as resp:
                for raw in resp:
                    line = raw.decode().strip()
                    if not line.startswith("data: ") or line == "data: [DONE]":
                        continue
                    chunk = json.loads(line[6:])
                    if _usage(chunk):
                        final = chunk
                    delta = chunk["choices"][0].get("delta", {}).get(
                        "content")
                    if delta:
                        t_last = time.monotonic()
                        if t_first is None:
                            t_first = t_last
                        reply.append(delta)
                        print(delta, end="", flush=True)
            print()
            usage = _usage(final)
            if usage is not None and t_first is not None:
                out_toks = int(usage["completion_tokens"])
                span = (t_last or t_first) - t_first
                rate = f" · {out_toks / span:.1f} tok/s" if span > 0 else ""
                ttft_ms = int((t_first - t0) * 1000)
                print(f"[{out_toks} tokens{rate} · ttft {ttft_ms} ms]")
        except KeyboardInterrupt:
            # Cancel the turn, keep the REPL alive.
            print("\n[interrupted]")
            history.pop()
            continue
        except Exception as e:
            print(f"\n[error: {e}]")
            history.pop()
            continue
        history.append({"role": "assistant", "content": "".join(reply)})


def main(argv: list[str] | None = None) -> int:
    parser = build_parser()
    args = parser.parse_args(argv)
    if args.command is None:
        parser.print_help()
        return 1
    item = UNPORTED_COMMANDS.get(args.command)
    if item is not None:
        print(f"parallax-tpu-torch {args.command}: not ported yet (ROADMAP "
              f"queue 1 item {item})", file=sys.stderr)
        return 2
    refused = unported_flags(args)
    if refused:
        for flag, item in refused:
            why = ("the port reads local checkpoint directories only"
                   if item is None else
                   f"not ported yet (ROADMAP queue 1 item {item})")
            print(f"parallax-tpu-torch {args.command}: {flag}: {why}",
                  file=sys.stderr)
        return 2
    if args.command == "serve":
        from parallax_tpu_torch.backend.serve import serve_main
        from parallax_tpu_torch.utils.banner import boot
        from parallax_tpu_torch.utils.hw import resolve_device

        boot(resolve_device(args.device))
        return serve_main(args)
    if args.command == "join":
        from parallax_tpu_torch.p2p.join import join_main

        return join_main(args)
    if args.command == "run":
        from parallax_tpu_torch.backend.run import run_main
        from parallax_tpu_torch.utils.banner import boot

        # The scheduler host touches no device: no device line.
        boot(None, probe=False)
        return run_main(args)
    if args.command == "chat":
        return chat_main(args)
    if args.command == "lora-merge":
        from parallax_tpu_torch.utils.adapter import merge_adapter

        n = merge_adapter(args.model_path, args.adapter_path, args.out_dir)
        print(f"merged {n} adapter modules -> {args.out_dir}")
        return 0
    if args.command == "chat-host":
        from parallax_tpu_torch.backend.run import chat_host_main

        return chat_host_main(args)
    from parallax_tpu_torch.backend.generate import generate_main

    return generate_main(args)


if __name__ == "__main__":
    sys.exit(main())
