"""The PyTorch port imports neither jax nor anything of parallax_tpu, nor
aiohttp, safetensors, msgpack or ml_dtypes (its serving and swarm paths
need none of them on the card), keeps transformers unimported until a
tokenizer is loaded, and its entry points refuse to fall back to the CPU
when no device was asked for."""

import os
import pkgutil
import subprocess
import sys

import pytest
import torch

import parallax_tpu_torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_BLOCKER = r"""
import importlib.abc, sys

class _Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        top = name.split(".")[0]
        if top in BLOCKED:
            raise ImportError(f"blocked import of {name}")
        return None

BLOCKED = ("jax", "jaxlib", "parallax_tpu", "aiohttp", "safetensors",
           "msgpack", "ml_dtypes")
for mod in list(sys.modules):
    if mod.split(".")[0] in BLOCKED:
        del sys.modules[mod]
sys.meta_path.insert(0, _Block())
"""


def _port_modules() -> list[str]:
    names = ["parallax_tpu_torch"]
    for info in pkgutil.walk_packages(
        parallax_tpu_torch.__path__, prefix="parallax_tpu_torch."
    ):
        names.append(info.name)
    return sorted(names)


def test_port_imports_without_jax_or_parallax_tpu():
    modules = _port_modules()
    # Every layer of the slice is there.
    for must in ("runtime.engine", "runtime.pipeline", "ops.attention",
                 "ops.decode_fused", "ops.prefill_fused", "ops.sampling",
                 "ops.cuda_kernels", "ops.grouped_matmul", "models.base",
                 "models.moe", "models.qwen3_moe", "models.presets",
                 "ops.mla", "ops.mla_decode", "ops.dsa", "ops.dsa_decode",
                 "models.deepseek_v3", "models.deepseek_v32",
                 "ops.gqa_decode", "models.gpt_oss", "runtime.step_graph",
                 "config", "models.loader", "utils.tokenizer",
                 "backend.http_server", "backend.serve", "backend.generate",
                 "cli", "p2p.wire", "p2p.proto", "p2p.transport", "p2p.node",
                 "p2p.join", "backend.run", "analysis.sanitizer",
                 "scheduling", "scheduling.node",
                 "scheduling.node_management",
                 "scheduling.layer_allocation",
                 "scheduling.request_routing", "scheduling.scheduler",
                 "backend.scheduler_service", "utils.hw", "ops.msa",
                 "models.minimax_m2", "models.minimax_m3", "constrained",
                 "constrained.automaton", "constrained.json_schema",
                 "constrained.vocab", "constrained.device_table",
                 "runtime.host_cache", "runtime.checkpoint",
                 "runtime.kv_handoff", "runtime.request", "ha",
                 "ha.backoff", "ha.failover", "ha.journal", "ha.standby",
                 "p2p.protowire", "p2p.interop", "backend.webui",
                 "native", "obs", "obs.names", "obs.registry",
                 "obs.flight", "obs.trace", "obs.goodput", "obs.device",
                 "obs.watchdog", "obs.slo", "obs.timeline", "obs.profiler",
                 "utils.request_metrics", "qos", "qos.classes",
                 "qos.admission", "qos.autoscaler", "router", "router.lb",
                 "testing", "testing.chaos", "testing.churn",
                 "models.glm4", "models.step3p5", "models.qwen3_next",
                 "ops.linear_attn", "ops.quant", "ops.quant_linear",
                 "ops.lora", "utils.adapter", "utils.st_writer",
                 "p2p.refit", "utils.compile_cache", "utils.banner",
                 "utils.version_check", "version"):
        assert f"parallax_tpu_torch.{must}" in modules
    code = _BLOCKER + (
        "import importlib\n"
        f"for m in {modules!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = [m for m in sys.modules\n"
        "       if m.split('.')[0] in BLOCKED + ('transformers',)]\n"
        "assert not bad, bad\n"
        "print('ok', len(sys.modules))\n"
    )
    res = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True,
        text=True, timeout=120,
        env={**os.environ, "PYTHONPATH": REPO},
    )
    assert res.returncode == 0, res.stderr
    assert res.stdout.startswith("ok")


def test_blocker_blocks_parallax_tpu_but_not_the_port():
    code = _BLOCKER + (
        "import parallax_tpu_torch.config\n"
        "try:\n"
        "    import parallax_tpu.config\n"
        "except ImportError:\n"
        "    print('blocked')\n"
    )
    res = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True,
        text=True, timeout=60, env={**os.environ, "PYTHONPATH": REPO},
    )
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "blocked"


def test_engine_without_device_needs_cuda():
    from parallax_tpu_torch.config import normalize_config
    from parallax_tpu_torch.models import create_stage_model
    from parallax_tpu_torch.runtime.engine import EngineConfig, StageEngine

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    cfg = normalize_config(dict(
        architectures=["Qwen2ForCausalLM"], hidden_size=32,
        num_hidden_layers=1, num_attention_heads=2, num_key_value_heads=1,
        intermediate_size=64, vocab_size=50,
    ))
    model = create_stage_model(cfg, 0, 1)
    params = model.init_params(torch.Generator().manual_seed(0),
                               torch.float32, "cpu")
    with pytest.raises(RuntimeError, match='device="cpu"'):
        StageEngine(model, params, EngineConfig(num_pages=16))
    # Asking for the CPU explicitly works; asking for kernels on it raises.
    StageEngine(model, params, EngineConfig(num_pages=16), device="cpu")
    with pytest.raises(ValueError, match="CUDA"):
        StageEngine(model, params, EngineConfig(num_pages=16,
                                                decode_fused=True),
                    device="cpu")


def test_kernel_wrappers_build_nothing_at_import():
    from parallax_tpu_torch.ops import cuda_kernels

    assert cuda_kernels._lib is None
    assert set(cuda_kernels.LAUNCHES) == {
        "kv_append", "gqa_prefill", "gqa_decode", "gqa_attend",
        "sample_topk", "grouped_gemm", "mla_decode", "mla_attend",
        "indexer_fused", "indexer_scores", "gumbel_rows", "quant_linear",
        "grouped_gemm_q",
    }


def test_serve_path_runs_without_aiohttp_or_safetensors(tmp_path):
    """With jax, parallax_tpu, aiohttp and safetensors blocked: a checkpoint
    written by chip_smoke.py's own writer loads, ``serve --device cpu``
    answers a chat completion over HTTP, and transformers stays unimported
    (the checkpoint has no tokenizer files)."""
    code = _BLOCKER + f"""
import http.client, importlib.util, json, threading
import torch
spec = importlib.util.spec_from_file_location("cs", {REPO!r} + "/chip_smoke.py")
cs = importlib.util.module_from_spec(spec)
spec.loader.exec_module(cs)
from parallax_tpu_torch import cli
from parallax_tpu_torch.backend.serve import serve_main
from parallax_tpu_torch.config import normalize_config
from parallax_tpu_torch.models import create_stage_model

raw = dict(architectures=["Qwen2ForCausalLM"], hidden_size=32,
           num_hidden_layers=2, num_attention_heads=2, num_key_value_heads=1,
           intermediate_size=64, vocab_size=270)
model = create_stage_model(normalize_config(raw), 0, 2)
tree = model.init_params(torch.Generator().manual_seed(0), torch.bfloat16,
                         "cpu")
cs.write_checkpoint(cs.hf_tensors(tree), raw, {str(tmp_path)!r})
args = cli.build_parser().parse_args([
    "serve", "--model-path", {str(tmp_path)!r}, "--device", "cpu",
    "--host", "127.0.0.1", "--port", "0", "--page-size", "8",
    "--max-batch-size", "2", "--max-model-len", "128"])
assert cli.unported_flags(args) == []
box, started = [], threading.Event()
thread = threading.Thread(
    target=serve_main, args=(args, lambda fe, r: (box.append(fe),
                                                  started.set())))
thread.start()
assert started.wait(60)
conn = http.client.HTTPConnection("127.0.0.1", box[0].port, timeout=60)
conn.request("POST", "/v1/chat/completions", body=json.dumps({{
    "messages": [{{"role": "user", "content": "hi"}}], "max_tokens": 4,
    "temperature": 0}}))
resp = conn.getresponse()
body = json.loads(resp.read())
box[0].shutdown()
thread.join(30)
assert resp.status == 200 and body["usage"]["completion_tokens"] == 4, body
bad = [m for m in sys.modules
       if m.split(".")[0] in BLOCKED + ("transformers",)]
assert not bad, bad
print("ok")
"""
    res = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True,
        text=True, timeout=120, env={**os.environ, "PYTHONPATH": REPO},
    )
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip().endswith("ok")


def test_swarm_runs_without_msgpack_or_ml_dtypes():
    """With jax, parallax_tpu, aiohttp, safetensors, msgpack and ml_dtypes
    blocked: a 2-stage swarm of port workers over TCP on the loopback
    interface gossips its route and serves a greedy request (the frames go
    through the port's own msgpack codec)."""
    code = _BLOCKER + """
import threading, time
import torch
from parallax_tpu_torch.config import normalize_config
from parallax_tpu_torch.p2p.node import WorkerNode
from parallax_tpu_torch.p2p.transport import TcpTransport
from parallax_tpu_torch.runtime.engine import EngineConfig
from parallax_tpu_torch.runtime.request import Request, SamplingParams

cfg = normalize_config(dict(
    architectures=["Qwen2ForCausalLM"], hidden_size=32, num_hidden_layers=2,
    num_attention_heads=2, num_key_value_heads=1, intermediate_size=64,
    vocab_size=50))
ts = [TcpTransport("", "127.0.0.1") for _ in range(2)]
workers = []
try:
    for t in ts:
        t.start()
        t.peer_id = t.address
    for i, t in enumerate(ts):
        workers.append(WorkerNode(
            t, None, cfg, EngineConfig(page_size=8, num_pages=16,
                                       max_model_len=64, kv_dtype="float32"),
            heartbeat_interval_s=0.2, static_peers=[ts[1 - i].address],
            layers=(i, i + 1), device="cpu"))
    for w in workers:
        w.start()
    deadline = time.monotonic() + 30
    while workers[0].local_route() is None and time.monotonic() < deadline:
        time.sleep(0.05)
    assert workers[0].local_route() == [t.address for t in ts]
    req = Request("r", prompt_ids=[1, 2, 3],
                  sampling_params=SamplingParams(temperature=0.0,
                                                 max_new_tokens=4))
    assert workers[0].submit(req).wait(30), req.status
    assert req.status.value == "finished_length" and len(req.output_ids) == 4
finally:
    for w in workers:
        w.stop()
bad = [m for m in sys.modules
       if m.split(".")[0] in BLOCKED + ("transformers",)]
assert not bad, bad
print("ok")
"""
    res = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True,
        text=True, timeout=120, env={**os.environ, "PYTHONPATH": REPO},
    )
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip().endswith("ok")
