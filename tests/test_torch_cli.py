"""The port's command line (``python -m parallax_tpu_torch``, ``cli.py``)
and its serving entry points on the CPU.

- ``generate --device cpu`` on a checkpoint written here prints the same
  text on stdout as ``python -m parallax_tpu.cli generate`` on it (greedy,
  float32 KV cache), and the stderr summary line.
- Every flag whose feature the port does not run yet, and every JAX
  subcommand not ported, exits with code 2 naming its ROADMAP item; the
  CLI is reachable as ``python -m parallax_tpu_torch`` and
  ``python -m parallax_tpu_torch.cli``.
- ``serve --device cpu`` on a thread answers a chat completion, its KV
  pages capped by what the configured batch can address.
- ``derive_num_pages`` / ``kv_bytes_per_page`` equal the JAX package's,
  and ``finalize_params`` is the identity on the dense and gpt-oss blocks.
"""

import http.client
import json
import os
import re
import subprocess
import sys
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from parallax_tpu.config import normalize_config as j_normalize
from parallax_tpu.models.base import StageModel as JStageModel
from parallax_tpu.models.presets import get_preset as j_get_preset
from parallax_tpu.runtime import cache_manager as jcm
from parallax_tpu_torch import cli
from parallax_tpu_torch.backend.serve import serve_main
from parallax_tpu_torch.config import normalize_config
from parallax_tpu_torch.models import create_stage_model
from parallax_tpu_torch.models.presets import get_preset
from parallax_tpu_torch.runtime import cache_manager
from parallax_tpu_torch.utils.hw import device_free_memory_bytes

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = dict(
    architectures=["Qwen2ForCausalLM"], hidden_size=64, num_hidden_layers=2,
    num_attention_heads=4, num_key_value_heads=2, intermediate_size=128,
    vocab_size=266, max_position_embeddings=512, tie_word_embeddings=False,
    torch_dtype="float32",
)
SUMMARY = re.compile(
    r"(\d+) prompt \+ (\d+) generated tokens \| ttft [\d.]+s \| decode "
    r"[\d.]+ tok/s \| (\w+)")


@pytest.fixture(scope="module")
def checkpoint(tmp_path_factory):
    """The tiny model's JAX init tree as an HF checkpoint (f32)."""
    from safetensors.numpy import save_file

    path = tmp_path_factory.mktemp("ckpt")
    params = JStageModel(j_normalize(TINY), 0, 2, use_pallas=False
                         ).init_params(jax.random.key(0), dtype=jnp.float32)
    tensors = {}

    def walk(prefix, node):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(f"{prefix}.{k}" if prefix else k, v)
        elif isinstance(node, list):
            for i, v in enumerate(node):
                walk(f"{prefix}.{i}", v)
        else:
            tensors[prefix if prefix.startswith("lm_head")
                    else f"model.{prefix}"] = np.asarray(node)

    walk("", params)
    save_file(tensors, str(path / "model.safetensors"))
    (path / "config.json").write_text(json.dumps(TINY))
    return str(path)


def _run(args, **env):
    return subprocess.run(
        [sys.executable, "-m", *args], cwd=REPO, capture_output=True,
        text=True, timeout=300,
        env={**os.environ, "PYTHONPATH": REPO, "JAX_PLATFORMS": "cpu", **env},
    )


def test_generate_matches_jax_cli(checkpoint):
    common = ["generate", "--model-path", checkpoint, "--kv-dtype",
              "float32", "--max-tokens", "16", "--prompt", "Hello there",
              "--tp-size", "1"]
    port = _run(["parallax_tpu_torch", *common, "--device", "cpu"])
    ref = _run(["parallax_tpu.cli", *common,
                "--compilation-cache-dir", "off"])
    assert port.returncode == 0, port.stderr
    assert ref.returncode == 0, ref.stderr
    assert port.stdout == ref.stdout
    assert port.stdout.strip()
    got, want = SUMMARY.search(port.stderr), SUMMARY.search(ref.stderr)
    assert got and want, (port.stderr, ref.stderr)
    assert got.groups() == want.groups()
    assert got.group(2) == "16" and got.group(3) == "finished_length"


def test_generate_needs_the_card_without_device_cpu(checkpoint):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    res = _run(["parallax_tpu_torch.cli", "generate", "--model-path",
                checkpoint, "--max-tokens", "2"])
    assert res.returncode != 0
    assert 'device="cpu"' in res.stderr


def test_refused_flag_exits_2_from_both_entry_points(checkpoint):
    for module in ("parallax_tpu_torch", "parallax_tpu_torch.cli"):
        res = _run([module, "serve", "--model-path", checkpoint,
                    "--tp-size", "2"])
        assert res.returncode == 2, res.stderr
        assert "--tp-size 2: not ported yet" in res.stderr
        assert "item 10" in res.stderr


# Flags once refused under ROADMAP item 9, which is ported now: the
# observability plane and QoS (``--qos``, ``--routing-gamma``).
_PORTED_OBS_FLAGS = {"--trace-sample-rate", "--watchdog", "--slo", "--qos",
                     "--routing-gamma"}


@pytest.mark.parametrize("argv,item", [
    (["serve", "--tp-size", "4"], 10),
    (["serve", "--sp-size", "2"], 10),
    (["serve", "--prefill-seq-parallel"], 10),
    (["serve", "--quantization", "int8"], 11),
    (["serve", "--lora-path", "/x"], 11),
    (["serve", "--lora-adapters", "a=/x"], 11),
    (["serve", "--lora-max-adapters", "2"], 11),
    # Speculation is ported; the JAX serve's refusal of a draft beside
    # tensor parallelism stands (the port refuses --tp-size > 1 itself).
    (["serve", "--draft-model-path", "/x", "--tp-size", "2"], 10),
    (["serve", "--speculative-tokens", "4", "--sp-size", "2"], 10),
    (["serve", "--wire-dtype", "fp8"], 11),
    (["serve", "--wire-dtype", "float8_e4m3fn"], 11),
    (["serve", "--trace-sample-rate", "0.5"], 9),
    (["serve", "--watchdog"], 9),
    (["serve", "--slo", "ttft_p95_ms=500"], 9),
    (["serve", "--qos", "on"], 9),
    (["serve", "--compilation-cache-dir", "/x"], 12),
    (["generate", "--tp-size", "2"], 10),
    (["generate", "--quantization", "int4"], 11),
    (["generate", "--lora-path", "/x"], 11),
])
def test_refused_flags_exit_2(checkpoint, capsys, argv, item):
    if argv[1] in _PORTED_OBS_FLAGS:
        # The observability and QoS planes are ported: these flags pass.
        args = cli.build_parser().parse_args(
            [argv[0], "--model-path", checkpoint, *argv[1:]])
        assert cli.unported_flags(args) == []
        return
    assert cli.main([argv[0], "--model-path", checkpoint, *argv[1:]]) == 2
    err = capsys.readouterr().err
    assert "not ported yet" in err and f"item {item})" in err


def test_hub_model_path_and_unported_commands_exit_2(capsys):
    assert cli.main(["serve", "--model-path", "Qwen/Qwen2.5-7B"]) == 2
    assert "hub download" in capsys.readouterr().err
    for command in cli.UNPORTED_COMMANDS:
        assert cli.main([command]) == 2
        assert "not ported yet" in capsys.readouterr().err
    assert cli.main([]) == 1


def test_full_layer_range_is_not_refused(checkpoint):
    args = cli.build_parser().parse_args(
        ["serve", "--model-path", checkpoint, "--start-layer", "0",
         "--end-layer", "2", "--tp-size", "1"])
    assert cli.unported_flags(args) == []


def test_serve_on_a_thread_answers_a_chat_completion(checkpoint):
    args = cli.build_parser().parse_args([
        "serve", "--model-path", checkpoint, "--device", "cpu",
        "--host", "127.0.0.1", "--port", "0", "--page-size", "8",
        "--max-batch-size", "4", "--max-model-len", "256",
        "--kv-dtype", "float32",
    ])
    assert cli.unported_flags(args) == []
    box, started = [], threading.Event()

    def on_start(frontend, runner):
        box.append((frontend, runner))
        started.set()

    thread = threading.Thread(target=serve_main, args=(args, on_start),
                              daemon=True)
    thread.start()
    assert started.wait(60)
    frontend, runner = box[0]
    try:
        conn = http.client.HTTPConnection("127.0.0.1", frontend.port,
                                          timeout=60)
        conn.request("POST", "/v1/chat/completions", body=json.dumps({
            "messages": [{"role": "user", "content": "hi"}],
            "max_tokens": 6, "temperature": 0}),
            headers={"Content-Type": "application/json"})
        resp = conn.getresponse()
        body = json.loads(resp.read())
        conn.close()
    finally:
        frontend.shutdown()
        thread.join(30)
    assert not thread.is_alive()
    assert resp.status == 200, body
    assert body["usage"]["completion_tokens"] == 6
    assert body["model"] == checkpoint
    engine = runner.pipeline.head
    # The pages the batch can address: (256 / 8 + 1) x 4 rows x 2.
    assert engine.cfg.num_pages == 264
    assert engine.cfg.prefill_chunk_size == 1024
    assert engine.kernel_dispatch_summary()["impl"] == "torch"
    (req,) = runner.pipeline.finished
    assert req.status.value == "finished_length"


def test_serve_host_cache_bytes_builds_the_tier(checkpoint):
    """``serve --host-cache-bytes`` is ported: the flag passes and the
    served engine carries a host KV tier of that budget; without the flag
    on the CPU the tier is off (the JAX serve's default there)."""
    args = cli.build_parser().parse_args([
        "serve", "--model-path", checkpoint, "--device", "cpu",
        "--host", "127.0.0.1", "--port", "0", "--page-size", "8",
        "--max-batch-size", "4", "--max-model-len", "256",
        "--kv-dtype", "float32", "--host-cache-bytes", str(1 << 20),
    ])
    assert cli.unported_flags(args) == []
    box, started = [], threading.Event()

    def on_start(frontend, runner):
        box.append((frontend, runner))
        started.set()

    thread = threading.Thread(target=serve_main, args=(args, on_start),
                              daemon=True)
    thread.start()
    assert started.wait(60)
    frontend, runner = box[0]
    try:
        engine = runner.pipeline.head
        assert engine.cfg.host_cache_bytes == 1 << 20
        tier = engine.host_tier
        assert tier is not None
        assert tier.capacity_pages == (1 << 20) // tier.pool.page_nbytes
        assert engine.cache_stats()["host_capacity_pages"] == \
            tier.capacity_pages
    finally:
        frontend.shutdown()
        thread.join(30)
    assert not thread.is_alive()
    from parallax_tpu_torch.utils.hw import default_host_cache_bytes

    assert default_host_cache_bytes(device="cpu") == 0
    assert default_host_cache_bytes(override=5, device="cpu") == 5


@pytest.mark.parametrize("name", ["qwen2.5-7b", "Qwen/Qwen3-30B-A3B",
                                  "deepseek-ai/DeepSeek-V3.2",
                                  "openai/gpt-oss-20b"])
def test_page_budget_matches_jax(name):
    cfg, jcfg = get_preset(name), j_get_preset(name)
    for layers, page, free in ((cfg.num_hidden_layers, 64, 60 << 30),
                               (5, 16, 3 << 30), (1, 64, 1 << 20)):
        assert cache_manager.kv_bytes_per_page(cfg, layers, page) == (
            jcm.kv_bytes_per_page(jcfg, layers, page))
        assert cache_manager.derive_num_pages(free, cfg, layers, page) == (
            jcm.derive_num_pages(free, jcfg, layers, page))
    assert cache_manager.derive_num_pages(1, cfg, 1, 64) == 8
    assert device_free_memory_bytes("cpu", 0.5) > 0


@pytest.mark.parametrize("raw", [TINY, dict(
    architectures=["GptOssForCausalLM"], hidden_size=64, num_hidden_layers=2,
    num_attention_heads=4, num_key_value_heads=2, head_dim=16,
    intermediate_size=32, num_local_experts=4, num_experts_per_tok=2,
    vocab_size=99)], ids=["dense", "gpt-oss"])
def test_finalize_params_is_the_identity(raw):
    import torch

    model = create_stage_model(normalize_config(raw), 0, 2)
    tree = model.init_params(torch.Generator().manual_seed(0),
                             torch.float32, "cpu")
    assert model.finalize_params(tree) is tree


def test_load_tokenizer_matches_jax(tmp_path):
    """The HF tokenizer when the checkpoint has tokenizer files (written
    here, offline), the byte tokenizer otherwise, in both packages."""
    from tokenizers import Tokenizer, models, pre_tokenizers
    from transformers import PreTrainedTokenizerFast

    from parallax_tpu.utils.tokenizer import load_tokenizer as j_load
    from parallax_tpu_torch.utils.tokenizer import (
        SimpleTokenizer,
        load_tokenizer,
    )

    words = ["[UNK]", "</s>", "hello", "there", "user", ":", "assistant"]
    tok = Tokenizer(models.WordLevel({w: i for i, w in enumerate(words)},
                                     unk_token="[UNK]"))
    tok.pre_tokenizer = pre_tokenizers.WhitespaceSplit()
    fast = PreTrainedTokenizerFast(tokenizer_object=tok, eos_token="</s>",
                                   unk_token="[UNK]")
    fast.chat_template = (
        "{% for m in messages %}{{ m['role'] }} : {{ m['content'] }} "
        "{% endfor %}{% if add_generation_prompt %}assistant :{% endif %}")
    fast.save_pretrained(str(tmp_path))
    got, want = load_tokenizer(str(tmp_path)), j_load(str(tmp_path))
    messages = [{"role": "user", "content": "hello there"}]
    for text in ("hello there", "there hello unknown", ""):
        assert got.encode(text) == want.encode(text)
    assert got.decode([2, 3, 1]) == want.decode([2, 3, 1]) == "hello there"
    assert got.eos_token_ids == want.eos_token_ids == (1,)
    assert got.apply_chat_template(messages) == want.apply_chat_template(
        messages)
    assert got.vocab_size == want.vocab_size == len(words)
    # No tokenizer files (or no path): the byte fallback.
    for path in (str(tmp_path / "none"), None):
        assert isinstance(load_tokenizer(path), SimpleTokenizer)
    byte = load_tokenizer(None)
    assert byte.encode("hé") == j_load(None).encode("hé") == [256, 104, 195,
                                                              169]


@pytest.mark.parametrize("argv", [
    ["run", "--model-name", "qwen2.5-7b"],
    ["run", "--model-name", "x", "--min-nodes", "2", "--port", "4001",
     "--routing", "cache_aware", "--routing-alpha", "2",
     "--routing-beta", "64", "--routing-imbalance", "3"],
    ["join", "--scheduler-addr", "10.0.0.1:3002", "--model-path", "."],
    ["join", "--scheduler-addr", "h:1", "--model-path", ".", "--port",
     "7000", "--advertise-addr", "127.0.0.1", "--wire-dtype", "bf16"],
    ["chat"],
    ["chat", "--base-url", "http://h:1", "--max-tokens", "9"],
    ["run", "--model-name", "x", "--scheduler-standby", "h:2,h:3"],
    ["run", "--model-name", "x", "--standby-of", "h:1", "--ha-lease-s",
     "3"],
    ["join", "--scheduler-addr", "h:1", "--scheduler-standby", "h:2",
     "--model-path", "."],
    ["run", "--model-name", "x", "--relay-token", "s3cret"],
    ["join", "--scheduler-addr", "h:1", "--model-path", ".", "--relay",
     "--relay-token", "s3cret"],
    ["serve", "--model-path", ".", "--wire-dtype", "bf16"],
], ids=["run-defaults", "run-cache-aware", "join-defaults", "join-flags",
        "chat-defaults", "chat-flags", "run-scheduler-standby",
        "run-standby-of", "join-scheduler-standby", "run-relay-token",
        "join-relay", "serve-wire-dtype"])
def test_run_join_chat_parse_as_the_jax_cli(argv):
    """``run``, ``join --scheduler-addr``, ``chat`` and ``serve`` take the
    JAX CLI's flags with its defaults (the port adds ``--host`` and
    ``--device``), and nothing of these is refused: the scheduler HA
    flags, the relay flags and ``serve --wire-dtype bf16`` included."""
    from parallax_tpu import cli as jcli

    want = vars(jcli.build_parser().parse_args(argv))
    got = vars(cli.build_parser().parse_args(argv))
    extra = set(got) - set(want)
    assert extra <= {"host", "device"}, extra
    assert {k: got[k] for k in want} == want
    assert cli.unported_flags(cli.build_parser().parse_args(argv)) == []


@pytest.mark.parametrize("argv,item", [
    (["--routing-gamma", "0.5"], 9),
    (["--slo", "ttft_p95_ms=500"], 9),
    (["--qos", "on"], 9),
])
def test_refused_run_flags_exit_2(capsys, argv, item):
    if argv[0] in _PORTED_OBS_FLAGS:
        args = cli.build_parser().parse_args(
            ["run", "--model-name", "qwen2.5-7b", *argv])
        assert cli.unported_flags(args) == []
        return
    assert cli.main(["run", "--model-name", "qwen2.5-7b", *argv]) == 2
    err = capsys.readouterr().err
    assert "not ported yet" in err and f"item {item})" in err


def _run_on_thread(argv):
    """``run`` (its parser and run_main) on a thread; returns the thread
    and its (frontend, service) once the HTTP socket is bound."""
    from parallax_tpu_torch.backend.run import run_main

    args = cli.build_parser().parse_args(argv)
    assert cli.unported_flags(args) == []
    box, started = [], threading.Event()
    server = threading.Thread(
        target=run_main,
        args=(args, lambda fe, svc: (box.extend((fe, svc)), started.set())),
        daemon=True)
    server.start()
    assert started.wait(30.0)
    return server, *box


def test_run_scheduler_standby_and_standby_of_serve_ha():
    """``run --scheduler-standby`` journals and advertises its standbys;
    ``run --standby-of P --ha-lease-s 1`` is a passive mirror tailing P:
    its frontend answers 503 and its RPC ``not_primary`` until P stops,
    then it promotes itself to epoch 2 and its frontend and RPC are a
    primary's. (A preset model, so no checkpoint; no worker joins.)"""
    from tests.test_torch_swarm import _post, _wait

    base = ["run", "--model-name", "qwen2.5-7b", "--port", "0", "--host",
            "127.0.0.1"]
    threads, frontends = [], []
    try:
        # The advertised standby address is only handed to workers and
        # clients: the primary never dials it (the standby pulls).
        server, fe, svc = _run_on_thread(base + ["--scheduler-standby",
                                                 "127.0.0.1:9"])
        threads.append(server)
        frontends.append(fe)
        journal = svc.scheduler.journal
        assert journal is not None and journal.records_by_kind == {
            "snapshot": 1}
        assert svc._with_epoch({})["standbys"] == ["127.0.0.1:9"]
        server2, fe2, svc2 = _run_on_thread(
            base + ["--standby-of", svc.transport.address, "--ha-lease-s",
                    "1"])
        threads.append(server2)
        frontends.append(fe2)
        mirror = svc2.scheduler
        assert mirror.passive and mirror.journal is None
        # The standby pulled the primary's journal and attached for pushes.
        assert _wait(lambda: journal._peers, 10.0)
        status, body = _post(fe2.port, "/v1/completions",
                             {"prompt": "hi", "max_tokens": 2})
        assert status == 503, body
        assert svc2._on_join("w", {"node_id": "w"})["not_primary"]
        assert _post(fe2.port, "/cluster/status_json", None, "GET")[0] == 200
        fe.shutdown()              # the primary's run returns
        server.join(30.0)
        assert not server.is_alive()
        assert _wait(lambda: not mirror.passive, 10.0)
        assert mirror.epoch == 2 and mirror.journal is not None
        assert svc2._on_where_is("w", {"rid": "r"}) == {}
        assert "not_primary" not in svc2._on_update("w", {"node_id": "w"})
    finally:
        for f in frontends:
            if f.server is not None:
                f.shutdown()
        for t in threads:
            t.join(30.0)


@pytest.mark.parametrize("flags", [["--start-layer", "1"],
                                   ["--end-layer", "1"]],
                         ids=["start-layer", "end-layer"])
def test_partial_serve_fails_with_the_jax_limit(checkpoint, flags):
    """A partial layer range cannot serve on one host in the JAX package
    either: its InProcessPipeline asserts that the engines hold the first
    and the last layer. The port's serve stops with that reason before it
    loads anything."""
    from parallax_tpu.runtime.engine import EngineConfig as JEngineConfig
    from parallax_tpu.runtime.engine import StageEngine as JStageEngine
    from parallax_tpu.runtime.pipeline import InProcessPipeline as JPipeline

    args = cli.build_parser().parse_args(
        ["serve", "--model-path", checkpoint, "--device", "cpu", *flags])
    assert cli.unported_flags(args) == []
    with pytest.raises(SystemExit, match="first and the last stage"):
        serve_main(args)
    s, e = (1, 2) if flags[0] == "--start-layer" else (0, 1)
    model = JStageModel(j_normalize(TINY), s, e, use_pallas=False)
    engine = JStageEngine(model, model.init_params(jax.random.key(0),
                                                   dtype=jnp.float32),
                          JEngineConfig(page_size=8, num_pages=8,
                                        max_model_len=32,
                                        kv_dtype="float32"))
    with pytest.raises(AssertionError):
        JPipeline([engine])


def test_serve_wire_dtype_reaches_the_engine_config(checkpoint):
    """``serve --wire-dtype bf16`` is carried into EngineConfig.wire_dtype,
    as the JAX serve does (one host has no hop: nothing else changes)."""
    args = cli.build_parser().parse_args([
        "serve", "--model-path", checkpoint, "--device", "cpu",
        "--host", "127.0.0.1", "--port", "0", "--page-size", "8",
        "--max-batch-size", "4", "--max-model-len", "256",
        "--kv-dtype", "float32", "--wire-dtype", "bf16",
    ])
    assert cli.unported_flags(args) == []
    box, started = [], threading.Event()
    thread = threading.Thread(
        target=serve_main,
        args=(args, lambda fe, runner: (box.append((fe, runner)),
                                        started.set())),
        daemon=True)
    thread.start()
    assert started.wait(60)
    frontend, runner = box[0]
    try:
        assert runner.pipeline.head.cfg.wire_dtype == "bf16"
        status, body = _post_json(frontend.port, "/v1/completions",
                                  {"prompt": "hi", "max_tokens": 3,
                                   "temperature": 0})
        assert status == 200 and body["usage"]["completion_tokens"] == 3
    finally:
        frontend.shutdown()
        thread.join(30)
    assert not thread.is_alive()


def _post_json(port, path, body):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    try:
        conn.request("POST", path, body=json.dumps(body),
                     headers={"Content-Type": "application/json"})
        resp = conn.getresponse()
        return resp.status, json.loads(resp.read())
    finally:
        conn.close()


def test_run_relay_token_and_join_relay_serve(checkpoint):
    """``run --relay-token`` puts the secret on the scheduler's transport
    (the relay); ``join --relay --relay-token --device cpu`` builds a
    worker behind it that registers its reverse route and joins; a wrong
    token is refused; ``join --relay`` without a scheduler exits as the
    JAX join does."""
    from parallax_tpu_torch.p2p.join import build_worker
    from tests.test_torch_swarm import _wait

    server, fe, svc = _run_on_thread(
        ["run", "--model-name", checkpoint, "--port", "0", "--host",
         "127.0.0.1", "--relay-token", "s3cret"])
    node = None
    try:
        relay = svc.transport
        assert relay.relay_token == "s3cret"
        base = ["join", "--scheduler-addr", relay.address, "--model-path",
                checkpoint, "--device", "cpu", "--port", "0", "--relay"]
        bad = build_worker(cli.build_parser().parse_args(
            base + ["--relay-token", "wrong"]))
        assert _wait(lambda: relay.transport_stats()["relay"]["rejected"]
                     >= 1, 10.0)
        assert bad.node_id not in relay._relay_routes
        bad.transport.stop()
        args = cli.build_parser().parse_args(base + ["--relay-token",
                                                     "s3cret"])
        assert cli.unported_flags(args) == []
        node = build_worker(args)
        assert node.node_id.startswith("relay:")
        assert node.node_id.endswith("@" + relay.address)
        assert node.resolve_model is not None
        assert _wait(lambda: node.node_id in relay._relay_routes, 10.0)
        node.start()
        assert _wait(lambda: node.engine is not None and any(
            n["ready"] for p in svc.scheduler.cluster_status()["pipelines"]
            for n in p["nodes"]), 30.0)
        status, body = _post_json(fe.port, "/v1/completions",
                                  {"prompt": "hi", "max_tokens": 3,
                                   "temperature": 0})
        assert status == 200 and body["usage"]["completion_tokens"] == 3
        assert node.transport.transport_stats()["accepted"] == 0
        assert relay.transport_stats()["relay"]["routed"][
            node.node_id]["envelopes"] > 0
    finally:
        if node is not None:
            node.stop()
        fe.shutdown()
        server.join(30.0)
    with pytest.raises(SystemExit, match="requires a scheduler"):
        build_worker(cli.build_parser().parse_args(
            ["join", "--model-path", checkpoint, "--device", "cpu",
             "--relay", "--start-layer", "0", "--end-layer", "2"]))
