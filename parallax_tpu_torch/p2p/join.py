"""``parallax-tpu-torch join`` entry: run a worker node until SIGINT /
SIGTERM (port of ``parallax_tpu/p2p/join.py``).

    python -m parallax_tpu_torch join --scheduler-addr 10.0.0.1:3002 \\
        --model-path DIR --port 7000
    python -m parallax_tpu_torch join --model-path DIR --start-layer 0 \\
        --end-layer 14 --peers 10.0.0.2:7001 --port 7000

With ``--scheduler-addr`` (``run``'s ``--port + 1``) the worker joins the
global scheduler, which assigns its layers; ``join`` blocks until the
scheduler bootstraps (``run --min-nodes``). ``--role prefill`` makes it a
prefill head that hands each finished prompt's KV pages to a ``--role
decode`` worker in frames of ``--kv-transfer-chunk-bytes``; the default
``mixed`` serves both phases. ``--scheduler-standby`` names warm-standby
schedulers (``run --standby-of``) its scheduler RPCs fail over to when the
primary dies. ``--relay`` puts the worker behind the scheduler's relay:
it accepts no dial, keeps one outbound connection to the scheduler and goes
by ``relay:<id>@<scheduler>`` (``--relay-token`` is the swarm's secret,
set on ``run`` too). A live model switch (``/scheduler/init``) resolves
the new model as a local checkpoint directory or a preset name (random
weights). Without ``--scheduler-addr``, the worker serves
layers ``[--start-layer, --end-layer)`` of the checkpoint and gossips its
block with ``--peers``; the one holding layer 0 routes requests itself.
Either way it runs on ``--device`` (default ``cuda:0``). Its KV pages come
from ``EngineConfig.num_pages``, as in the JAX join, so two workers share
one card. Its host KV tier gets ``--host-cache-bytes``, by default half of
the host's available RAM on a card and none on the CPU, as the JAX join
sizes it. ``--qos on`` (or a ``qos/classes.parse_qos_spec`` spec) runs
the QoS plane on the worker's local scheduler.
"""

from __future__ import annotations

import json
import os
import signal
import socket
import threading
import uuid

from parallax_tpu_torch.utils import get_logger

logger = get_logger(__name__)


def _default_route_ip() -> str:
    """Best-effort externally reachable IP (the UDP-connect trick: no
    packet is sent)."""
    try:
        s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        s.connect(("10.255.255.255", 1))
        ip = s.getsockname()[0]
        s.close()
        return ip
    except Exception:
        return "127.0.0.1"


def build_worker(args):
    """The worker node ``args`` describe, on a started transport (not yet
    started itself)."""
    from parallax_tpu_torch.config import (
        load_config,
        resolve_speculative_tokens,
    )
    from parallax_tpu_torch.models.loader import load_stage_params
    from parallax_tpu_torch.p2p.node import WorkerNode
    from parallax_tpu_torch.p2p.transport import TcpTransport
    from parallax_tpu_torch.runtime.engine import EngineConfig
    from parallax_tpu_torch.utils.hw import (
        default_host_cache_bytes,
        resolve_device,
    )

    from parallax_tpu_torch.models.presets import get_preset

    standalone = args.scheduler_addr is None
    if standalone:
        if args.relay:
            raise SystemExit("--relay requires a scheduler as the relay")
        if args.start_layer is None or args.end_layer is None:
            raise SystemExit(
                "scheduler-less mode needs --start-layer/--end-layer "
                "(and --peers unless one host serves every layer)"
            )
    if not args.model_path:
        raise SystemExit("--model-path is required (checkpoint directory)")
    device = resolve_device(args.device)
    model_config = load_config(args.model_path)

    def resolve_model(name: str):
        """A live model switch: a directory this worker can read loads
        its weights; a known preset serves seeded random weights;
        anything else refuses the switch."""
        if os.path.isdir(name):
            return load_config(name), (
                lambda model: load_stage_params(model, name, device=device))
        try:
            return get_preset(name), None
        except KeyError:
            raise RuntimeError(
                f"model {name!r} is neither a local checkpoint nor a known "
                "preset on this worker") from None

    transport = TcpTransport("", "0.0.0.0", args.port,
                             relay_token=args.relay_token)
    transport.start()
    if args.relay:
        # Behind a NAT: no inbound dials; a reverse connection at the
        # scheduler's transport and a relay address.
        transport.peer_id = (
            f"relay:{uuid.uuid4().hex[:12]}@{args.scheduler_addr}")
        transport.register_at_relay(args.scheduler_addr)
    else:
        # The node id doubles as the dial address peers use for
        # pp-forwards: it must be reachable, never the 0.0.0.0 bind
        # address.
        advertise_host = args.advertise_addr or _default_route_ip()
        transport.peer_id = f"{advertise_host}:{transport.port}"
    return WorkerNode(
        transport=transport,
        scheduler_peer=args.scheduler_addr,
        model_config=model_config,
        engine_config=EngineConfig(
            # None/0 = adaptive multi-step decode (engine default; the
            # window stays inert on a stage of a pipeline).
            decode_lookahead=args.decode_lookahead or None,
            decode_fused=args.decode_fused,
            prefill_fused=args.prefill_fused,
            prefill_chunk_skip=args.prefill_chunk_skip,
            decode_pipeline=args.decode_pipeline or 1,
            wire_dtype=args.wire_dtype,
            # Observability: trace sampling and the slow-request threshold.
            trace_sample_rate=args.trace_sample_rate or 0.0,
            slow_request_ms=args.slow_request_ms,
            # Multi-tenant QoS on this worker's local scheduler: deadline
            # EDF and shed / park enforcement; the cluster controller's
            # shed verdict arrives in heartbeat replies and ORs with it.
            qos=getattr(args, "qos", None),
            host_cache_bytes=default_host_cache_bytes(
                override=args.host_cache_bytes, device=device),
            # Speculative decoding: on a stage of a pipeline the head
            # proposes and the last stage verifies (pipeline speculation);
            # a worker serving every layer speculates in its window.
            speculative_tokens=resolve_speculative_tokens(
                args.speculative_tokens),
            speculative_ngram=args.speculative_ngram or 3,
        ),
        load_params=lambda model: load_stage_params(
            model, args.model_path, device=device),
        static_peers=[
            p.strip() for p in (args.peers or "").split(",") if p.strip()
        ],
        layers=(args.start_layer, args.end_layer) if standalone else None,
        device=device,
        tokenizer_path=args.model_path,
        role=args.role,
        kv_transfer_chunk_bytes=args.kv_transfer_chunk_bytes,
        # Scheduler HA: seed standby addresses for the failover rotation;
        # the primary's replies extend the list.
        scheduler_standby=[
            p.strip() for p in (args.scheduler_standby or "").split(",")
            if p.strip()
        ],
        resolve_model=resolve_model,
        # The stall watchdog: off by default (no monitor thread, no
        # per-step work).
        watchdog=bool(args.watchdog),
        watchdog_degraded_s=args.watchdog_degraded_s,
        watchdog_stalled_s=args.watchdog_stalled_s,
    )


def join_main(args, on_start=None) -> int:
    """Run the worker until SIGINT / SIGTERM, then stop it (in scheduler
    mode that sends ``node_leave``), log its engine's
    ``kernel_dispatch_summary()``, the process's kernel launches, its
    ``transport_stats()`` and its observability summary (goodput tokens,
    watchdog status, and each held trace's (stage, span) names, the last
    16) as JSON lines and return 0.
    ``on_start(node)`` runs once the node started (its engine builds on
    the step thread)."""
    from parallax_tpu_torch.ops import cuda_kernels as ck

    node = build_worker(args)
    stop = threading.Event()
    signal.signal(signal.SIGINT, lambda *_: stop.set())
    signal.signal(signal.SIGTERM, lambda *_: stop.set())
    node.start()
    if node.standalone:
        logger.info("worker %s serving layers [%d, %d) scheduler-less, "
                    "peers %s", node.node_id, args.start_layer,
                    args.end_layer, node.static_peers)
    else:
        logger.info("worker %s joined scheduler %s", node.node_id,
                    args.scheduler_addr)
    if on_start is not None:
        on_start(node)
    stop.wait()
    node.stop()
    if node.engine is not None:
        logger.info("kernel dispatch: %s",
                    json.dumps(node.engine.kernel_dispatch_summary()))
    logger.info("kernel launches: %s", json.dumps(ck.launches()))
    logger.info("transport: %s", json.dumps(node.transport_stats()))
    from parallax_tpu_torch.obs.goodput import get_goodput
    from parallax_tpu_torch.obs.trace import get_trace_store

    store = get_trace_store()
    logger.info("obs: %s", json.dumps({
        "goodput_tokens": get_goodput().snapshot()["tokens"],
        "health": node.health_summary()["status"],
        "traces": {rid: [[s["stage"], s["name"]]
                         for s in store.spans(rid) or ()]
                   for rid in store.trace_ids()[-16:]},
    }))
    return 0
