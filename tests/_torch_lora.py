"""Shared set-up of the port's LoRA tests: one tiny Qwen2 (4 layers, width
64) whose weights come from the JAX package's ``init_params`` (key 0, f32)
and cross to the port through numpy, the JAX tests' seeded adapters, and
helpers that run both packages' engines and pipelines."""

import jax
import jax.numpy as jnp
import numpy as np

import tests._torch_cpu  # noqa: F401  (one intra-op thread)

from parallax_tpu.config import normalize_config as j_normalize
from parallax_tpu.models.base import BatchInputs as JBatch
from parallax_tpu.models.base import StageModel as JStageModel
from parallax_tpu.ops.lora import AdapterSet as JAdapterSet
from parallax_tpu.runtime.engine import EngineConfig as JEngineConfig
from parallax_tpu.runtime.engine import StageEngine as JStageEngine
from parallax_tpu.runtime.pipeline import InProcessPipeline as JPipeline
from parallax_tpu.runtime.request import Request as JRequest
from parallax_tpu.runtime.request import SamplingParams as JSampling
from parallax_tpu_torch.config import normalize_config
from parallax_tpu_torch.models import create_stage_model, params_from_numpy
from parallax_tpu_torch.runtime.engine import EngineConfig, StageEngine
from parallax_tpu_torch.runtime.pipeline import InProcessPipeline
from parallax_tpu_torch.runtime.request import Request, SamplingParams

RAW = dict(
    architectures=["Qwen2ForCausalLM"], hidden_size=64, num_hidden_layers=4,
    num_attention_heads=4, num_key_value_heads=2, intermediate_size=128,
    vocab_size=151, max_position_embeddings=256,
)
CFG = normalize_config(RAW)
JCFG = j_normalize(RAW)
# The JAX tests' engine settings.
ENGINE = dict(page_size=8, num_pages=128, max_model_len=128,
              kv_dtype="float32", max_num_tokens_per_batch=128,
              max_batch_size=8)
# The tie-tolerant greedy limit of tests/test_engine_e2e.py.
TOL = 5e-3

_PARAMS: dict = {}


def jax_params(start=0, end=4, key=0):
    """JAX ``init_params`` of a stage (f32) and the same tree as numpy."""
    k = (start, end, key)
    if k not in _PARAMS:
        p = JStageModel(JCFG, start, end, use_pallas=False).init_params(
            jax.random.key(key), dtype=jnp.float32)
        _PARAMS[k] = (p, jax.tree.map(np.asarray, p))
    return _PARAMS[k]


def make_adapter(seed: int, layers, rank: int = 4, scale: float = 0.5):
    """The JAX tests' adapter: {local_layer: {path: (A, B, scale)}} on
    q_proj and gate_proj, numpy f32."""
    rng = np.random.default_rng(seed)
    h, inter = RAW["hidden_size"], RAW["intermediate_size"]
    tree = {}
    for li in layers:
        tree[li] = {
            "self_attn.q_proj": (
                rng.standard_normal((rank, h)).astype(np.float32) * 0.1,
                rng.standard_normal((h, rank)).astype(np.float32) * 0.1,
                scale,
            ),
            "mlp.gate_proj": (
                rng.standard_normal((rank, h)).astype(np.float32) * 0.1,
                rng.standard_normal((inter, rank)).astype(np.float32) * 0.1,
                scale,
            ),
        }
    return tree


def full_adapter(seed: int, layers, rank: int = 4, scale: float = 0.5,
                 paths=None):
    """An adapter on every supported projection (or ``paths``)."""
    rng = np.random.default_rng(seed)
    h, inter = RAW["hidden_size"], RAW["intermediate_size"]
    kvd = RAW["num_key_value_heads"] * (h // RAW["num_attention_heads"])
    dims = {"self_attn.q_proj": (h, h), "self_attn.k_proj": (h, kvd),
            "self_attn.v_proj": (h, kvd), "self_attn.o_proj": (h, h),
            "mlp.gate_proj": (h, inter), "mlp.up_proj": (h, inter),
            "mlp.down_proj": (inter, h)}
    return {li: {
        p: (rng.standard_normal((rank, dims[p][0])).astype(np.float32) * 0.1,
            rng.standard_normal((dims[p][1], rank)).astype(np.float32) * 0.1,
            scale)
        for p in (paths or dims)} for li in layers}


def sub_tree(tree, start, end):
    """A stage's slice of an adapter tree, re-keyed to local layers."""
    return {gi - start: lt for gi, lt in tree.items() if start <= gi < end}


def stage_np(full_np, start, end):
    p = {"layers": full_np["layers"][start:end]}
    if start == 0:
        p["embed_tokens"] = full_np["embed_tokens"]
    if end == RAW["num_hidden_layers"]:
        p["norm"] = full_np["norm"]
        p["lm_head"] = full_np["lm_head"]
    return p


def port_engines(adapters=None, bounds=((0, 4),), params_np=None,
                 **cfg) -> list[StageEngine]:
    """Port engines over ``bounds`` on the JAX package's weights, each with
    its slice of every adapter."""
    full_np = params_np if params_np is not None else jax_params()[1]
    engines = []
    for s, e in bounds:
        eng = StageEngine(create_stage_model(CFG, s, e),
                          params_from_numpy(stage_np(full_np, s, e), "cpu"),
                          EngineConfig(**dict(ENGINE, **cfg)), device="cpu")
        for name, tree in (adapters or {}).items():
            eng.load_adapter(name, sub_tree(tree, s, e))
        engines.append(eng)
    return engines


def jax_engines(adapters=None, bounds=((0, 4),), params=None, **cfg):
    full = params if params is not None else jax_params()[0]
    engines = []
    for s, e in bounds:
        sp = {"layers": full["layers"][s:e]}
        if s == 0:
            sp["embed_tokens"] = full["embed_tokens"]
        if e == RAW["num_hidden_layers"]:
            sp["norm"], sp["lm_head"] = full["norm"], full["lm_head"]
        eng = JStageEngine(JStageModel(JCFG, s, e, use_pallas=False), sp,
                           JEngineConfig(**dict(ENGINE, **cfg)))
        for name, tree in (adapters or {}).items():
            eng.load_adapter(name, sub_tree(tree, s, e))
        engines.append(eng)
    return engines


def run(engines, specs, n=8, jax_side=False):
    """Serve ``specs`` ([(rid, prompt, lora_id)]) to completion through an
    in-process pipeline over ``engines``; returns the requests."""
    pipe = (JPipeline if jax_side else InProcessPipeline)(list(engines))
    req_cls, sp_cls = (JRequest, JSampling) if jax_side else (
        Request, SamplingParams)
    reqs = []
    for rid, prompt, lid in specs:
        r = req_cls(rid, prompt_ids=list(prompt), lora_id=lid,
                    sampling_params=sp_cls(temperature=0.0, max_new_tokens=n,
                                           ignore_eos=True))
        pipe.submit(r)
        reqs.append(r)
    pipe.run_until_complete()
    for r in reqs:
        assert r.status.is_finished
    return reqs


def reference_logits(ctx, adapter=None):
    """JAX StageModel logits at every position of ``ctx`` in one forward,
    with ``adapter`` (a tree) applied through the JAX package's own
    stacked delta."""
    full = jax_params()[0]
    n = len(ctx)
    t = 1 << (n - 1).bit_length()
    model = JStageModel(JCFG, 0, 4, use_pallas=False)
    page = 8
    npages = (n + page - 1) // page
    kv = model.new_kv_caches(npages + 1, page, jnp.float32)
    tok = np.zeros(t, np.int32)
    tok[:n] = ctx
    pos = np.zeros(t, np.int32)
    pos[:n] = np.arange(n)
    slots = np.full(t, -1, np.int32)
    slots[:n] = np.arange(n) + page
    lora = None
    if adapter is not None:
        js = JAdapterSet()
        js.register("x", adapter)
        lora = js.batch_field("x")
    inp = JBatch(
        token_ids=jnp.asarray(tok), hidden_states=None,
        positions=jnp.asarray(pos), kv_lens=jnp.asarray([n], jnp.int32),
        page_indices=jnp.asarray(np.arange(1, npages + 1)[None], jnp.int32),
        cu_q_lens=jnp.asarray([0, n], jnp.int32),
        num_seqs=jnp.asarray([1], jnp.int32), slot_mapping=jnp.asarray(slots),
        logits_indices=jnp.arange(t, dtype=jnp.int32), lora=lora,
    )
    logits, _ = model(full, kv, inp)
    return np.asarray(logits)[:n]


def assert_greedy_matches(port_req, adapter, jax_req=None):
    """Tie-tolerant greedy rule (tests/test_engine_e2e.py, tol 5e-3): every
    port token is within TOL of the JAX reference's argmax at its position
    (the JAX StageModel over the whole stream with the same adapter); where
    the port's and the JAX engine's streams part, they part at a near-tie.
    """
    out = list(port_req.output_ids)
    ctx = list(port_req.prompt_ids) + out[:-1]
    logits = reference_logits(ctx, adapter)
    p0 = len(port_req.prompt_ids)
    for i, tok in enumerate(out):
        row = logits[p0 - 1 + i]
        best = int(np.argmax(row))
        gap = float(row[best] - row[tok])
        assert tok == best or gap < TOL, (port_req.request_id, i, tok, best,
                                          gap)
    if jax_req is not None:
        other = list(jax_req.output_ids)
        assert len(other) == len(out)
        same = 0
        while same < len(out) and out[same] == other[same]:
            same += 1
        if same < len(out):
            row = logits[p0 - 1 + same]
            gap = abs(float(row[out[same]] - row[other[same]]))
            assert gap < TOL, (port_req.request_id, same, gap)
