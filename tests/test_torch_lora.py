"""Per-request LoRA in the port (``ops/lora.py``, the delta in
``models/layers.py``, the engine's adapter field, the scheduler's grouping
and the adapter-namespaced prefix caches) held against the JAX package on
the same seeded numpy weights and adapters, on the CPU.

Tolerances: stacks are bitwise (the same f32 values placed the same way);
deltas, linears, stage logits and merges agree to f32 ``allclose`` (rtol
1e-5, atol 1e-5: the products sum in other orders); streams pass the
tie-tolerant greedy rule of tests/test_engine_e2e.py (tol 5e-3) against the
JAX StageModel with the same adapter, and where the port's and the JAX
engine's streams part they part at a near-tie. Inside the port, K = 1
sync against K = 8 windows, sync against overlap and a mixed batch against
each tenant served alone are bitwise (equal token streams).

The reference cases are those of tests/test_lora_serving.py except the two
tensor-parallel ones (item 10), tests/test_periphery.py's merges and
tests/test_utils_periphery.py's offline merges; the swarm, routing and
HTTP cases are in tests/test_torch_lora_swarm.py. Port-only: a graph
replayed window that switches adapters between windows of one key, a
re-stack after capture, the null slot on a non-head stage, and a
per-request adapter over an int8 tree.
"""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests._torch_lora import (
    CFG,
    ENGINE,
    JCFG,
    RAW,
    assert_greedy_matches,
    full_adapter,
    jax_engines,
    jax_params,
    make_adapter,
    port_engines,
    run,
)

from parallax_tpu.models import layers as JL
from parallax_tpu.models.base import BatchInputs as JBatch
from parallax_tpu.models.base import StageModel as JStageModel
from parallax_tpu.ops import lora as jlora
from parallax_tpu_torch.models import create_stage_model, params_from_numpy
from parallax_tpu_torch.models import layers as L
from parallax_tpu_torch.models.base import BatchInputs
from parallax_tpu_torch.ops import lora
from parallax_tpu_torch.runtime.engine import drive_step
from parallax_tpu_torch.runtime.request import Request, SamplingParams

AD1 = make_adapter(1, layers=[0, 2])
AD2 = make_adapter(2, layers=[1, 3])
PROMPT = [1, 2, 3, 4, 5]
ALLCLOSE = dict(rtol=1e-5, atol=1e-5)


def _np(t):
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else \
        np.asarray(t)


# -- ops/lora.py ------------------------------------------------------------

def _three_adapter_sets():
    """Both packages' sets over the same three adapters: rank 4 on q / gate
    everywhere, rank 2 (padding), and rank 4 on every projection of layer 1
    only (the union of sites)."""
    trees = {"r4": make_adapter(11, [0, 1, 2, 3]),
             "r2": make_adapter(12, [0, 1, 2, 3], rank=2, scale=0.25),
             "wide": full_adapter(13, [1])}
    js, ps = jlora.AdapterSet(), lora.AdapterSet(device="cpu")
    for name, tree in trees.items():
        js.register(name, tree)
        ps.register(name, tree)
    return trees, js, ps


def test_stacks_match_jax_with_rank_padding_and_site_union():
    _, js, ps = _three_adapter_sets()
    jf, pf = js.batch_field("r2"), ps.batch_field("r2")
    assert int(jf["slot"]) == int(pf["slot"][0]) == 1
    assert pf["slot"].dtype == torch.int64 and pf["slot"].shape == (1,)
    assert set(jf["layers"]) == set(pf["layers"])
    for li, layer in jf["layers"].items():
        assert set(layer) == set(pf["layers"][li])
        for path, ab in layer.items():
            for k in ("A", "B", "s"):
                got = pf["layers"][li][path][k]
                assert got.dtype == torch.float32
                np.testing.assert_array_equal(_np(got), np.asarray(ab[k]))
    # Rank padding: the rank-2 adapter's rows past 2 are zero; layer 1's
    # o_proj exists only in the wide adapter, zero for the other slots.
    a = _np(pf["layers"]["0"]["self_attn.q_proj"]["A"])
    assert a.shape == (3, 4, 64) and not a[1, 2:].any()
    o = _np(pf["layers"]["1"]["self_attn.o_proj"]["B"])
    assert o.shape == (3, 64, 4) and not o[:2].any() and o[2].any()
    # The mixed form's [n * r, out] reading of B is a view, no copy.
    b = pf["layers"]["0"]["mlp.gate_proj"]["B"]
    assert b.transpose(1, 2).is_contiguous()
    assert ps.token_slot(None) == js.token_slot(None) == 3
    assert ps.names == js.names


def test_lru_eviction_matches_jax():
    """The hot-load LRU: past the cap the least-recently USED adapter goes,
    never an active one nor the one registering; slots follow the
    registration order."""
    js, ps = jlora.AdapterSet(max_adapters=2), lora.AdapterSet(
        max_adapters=2, device="cpu")
    seq = [("register", "a", ()), ("register", "b", ()), ("touch", "a"),
           ("register", "c", ()), ("register", "d", ("c",)),
           ("touch", "c"), ("register", "e", ("d",))]
    for op in seq:
        if op[0] == "touch":
            js.touch(op[1])
            ps.touch(op[1])
            continue
        tree = make_adapter(ord(op[1]), [0])
        assert (js.register(op[1], tree, active=op[2])
                == ps.register(op[1], tree, active=op[2]))
        assert js.names == ps.names
    assert ps.evicted_total == js.evicted_total == 3
    gen = ps.generation
    ps.batch_field("e")
    assert ps.generation == gen + 1      # a re-stack after the change
    ps.batch_field("e")
    assert ps.generation == gen + 1      # and no other


@pytest.mark.parametrize("form", ["uniform", "mixed"])
def test_delta_and_linear_match_jax(form):
    """``_lora_delta`` and ``linear`` (bias added last) against the JAX
    package's, f32 ``allclose``; in the mixed form a base row (the null
    slot) gets an exactly zero delta."""
    _, js, ps = _three_adapter_sets()
    rng = np.random.default_rng(5)
    x = rng.standard_normal((6, 64)).astype(np.float32)
    w = rng.standard_normal((128, 64)).astype(np.float32) * 0.1
    bias = rng.standard_normal((128,)).astype(np.float32)
    path = ("1", "mlp.gate_proj")
    if form == "uniform":
        jsel = jlora.select_slot(js.batch_field("r2"))
        psel = lora.select_slot(ps.batch_field("r2"))
    else:
        slots = np.array([0, 1, 2, 3, 2, 0], np.int32)
        jsel = jlora.select_slot(js.mixed_batch_field(slots))
        psel = lora.select_slot(ps.mixed_batch_field(slots))
    jab, pab = jsel[path[0]][path[1]], psel[path[0]][path[1]]
    want = np.asarray(JL._lora_delta(jnp.asarray(x), jab))
    got = _np(L._lora_delta(torch.from_numpy(x), pab))
    np.testing.assert_allclose(got, want, **ALLCLOSE)
    assert np.abs(want).max() > 1e-2
    if form == "mixed":
        assert not got[3].any()
    jp = {"weight": jnp.asarray(w), "bias": jnp.asarray(bias), "lora": jab}
    pp = {"weight": torch.from_numpy(w), "bias": torch.from_numpy(bias),
          "lora": pab}
    np.testing.assert_allclose(
        _np(L.linear(torch.from_numpy(x), pp)),
        np.asarray(JL.linear(jnp.asarray(x), jp)), **ALLCLOSE)


def test_select_slot_refuses_tensor_parallel_by_name():
    _, _, ps = _three_adapter_sets()
    field = ps.batch_field("r4")
    sel = lora.select_slot(field, axis_name=None, tp=1)
    # Every site carries the stacked tensors and the batch's device slot
    # (the delta selects by comparison, in the step).
    site = sel["0"]["self_attn.q_proj"]
    assert site["slot"] is field["slot"]
    assert site["A"] is field["layers"]["0"]["self_attn.q_proj"]["A"]
    with pytest.raises(NotImplementedError, match=r"item 10\)"):
        lora.select_slot(field, axis_name="tp", tp=2)


def test_merge_layer_lora_skips_absent_paths():
    lp = {"self_attn": {"q_proj": {"weight": 1}}, "mlp": {}}
    sel = {"self_attn.q_proj": {"A": 1}, "mlp.up_proj": {"A": 2}}
    for mod in (lora, jlora):
        out = mod.merge_layer_lora(lp, sel)
        assert out["self_attn"]["q_proj"]["lora"] == {"A": 1}
        assert "lora" not in lp["self_attn"]["q_proj"]
        assert out["mlp"] == {}


def test_tp_rejects_indivisible_adapter_dims():
    """``validate_tp_shardable`` alone (tensor parallelism waits for item
    10): the port's raises where the JAX package's does."""
    for tree in ({0: {"self_attn.q_proj": (np.zeros((4, 64), np.float32),
                                           np.zeros((63, 4), np.float32),
                                           1.0)}},
                 {0: {"mlp.down_proj": (np.zeros((4, 63), np.float32),
                                        np.zeros((64, 4), np.float32),
                                        1.0)}}):
        for mod in (lora, jlora):
            with pytest.raises(ValueError, match="not divisible"):
                mod.validate_tp_shardable(tree, 2)
            mod.validate_tp_shardable(tree, 1)


def test_parse_adapter_spec_and_intersection():
    for mod in (lora, jlora):
        assert mod.parse_adapter_spec("a=/p/a, b=/p/b") == {
            "a": "/p/a", "b": "/p/b"}
        assert mod.parse_adapter_spec(None) == {}
        with pytest.raises(ValueError):
            mod.parse_adapter_spec("oops")
        assert mod.intersect_adapter_names([["b", "a"], ["a", "c"]]) == ["a"]
        assert mod.intersect_adapter_names([]) == []


# -- PEFT directories -------------------------------------------------------

def _write_peft(path, tree, rank=4, alpha=8.0, extra=None, dora=None):
    """A PEFT directory through the port's writer (``use_rslora`` /
    ``alpha_pattern`` via ``extra``; ``dora`` adds magnitude vectors)."""
    from parallax_tpu_torch.utils.st_writer import (
        write_peft_adapter,
        write_safetensors,
    )

    write_peft_adapter(str(path), tree, rank=rank, alpha=alpha,
                       extra_config=extra)
    if dora:
        from parallax_tpu_torch.models.loader import SafetensorsFile

        st = SafetensorsFile(str(path / "adapter_model.safetensors"))
        tensors = {k: st.get_tensor(k).clone() for k in st.keys()}
        for key, m in dora.items():
            tensors[f"{key}.lora_magnitude_vector.weight"] = \
                torch.from_numpy(m)
        del st
        write_safetensors(str(path / "adapter_model.safetensors"), tensors)
    return str(path)


@pytest.mark.parametrize("extra", [
    None, {"use_rslora": True},
    {"alpha_pattern": {"layers.2.mlp.gate_proj": 2.0}},
], ids=["plain", "rslora", "alpha-pattern"])
def test_peft_slicing_matches_jax(tmp_path, extra):
    path = _write_peft(tmp_path / "ad", make_adapter(3, [0, 2]), extra=extra)
    for s, e in ((0, 2), (2, 4), (0, 4)):
        jt = jlora.adapter_tree_from_peft(path, s, e)
        pt = lora.adapter_tree_from_peft(path, s, e)
        assert set(jt) == set(pt)
        for li in jt:
            assert set(jt[li]) == set(pt[li])
            for p, (a, b, sc) in jt[li].items():
                pa, pb, psc = pt[li][p]
                np.testing.assert_array_equal(_np(pa), a)
                np.testing.assert_array_equal(_np(pb), b)
                assert psc == sc
    t1 = lora.adapter_tree_from_peft(path, 2, 4)
    assert list(t1) == [0]          # global layer 2 -> local 0
    assert lora.adapter_tree_from_peft(path, 1, 2) == {}


def test_peft_refusals_match_jax(tmp_path):
    dora = _write_peft(
        tmp_path / "dora", make_adapter(4, [0]), dora={
            "base_model.model.model.layers.0.self_attn.q_proj":
                np.ones(64, np.float32)})
    for mod in (lora, jlora):
        with pytest.raises(ValueError, match="DoRA"):
            mod.adapter_tree_from_peft(dora, 0, 4)
    bad = _write_peft(tmp_path / "bad", {0: {"mlp.experts": (
        np.zeros((4, 64), np.float32), np.zeros((64, 4), np.float32), 2.0)}})
    for mod in (lora, jlora):
        with pytest.raises(ValueError, match="unsupported adapter target"):
            mod.adapter_tree_from_peft(bad, 0, 4)


# -- the model --------------------------------------------------------------

def _stage_inputs(n_tokens=7):
    """One prefill segment of ``n_tokens`` tokens through a fresh cache, as
    both packages' BatchInputs (token bucket 8)."""
    t = 8
    tok = np.zeros(t, np.int32)
    tok[:n_tokens] = np.arange(1, n_tokens + 1)
    pos = np.zeros(t, np.int32)
    pos[:n_tokens] = np.arange(n_tokens)
    slots = np.full(t, -1, np.int32)
    slots[:n_tokens] = np.arange(n_tokens) + 8
    common = dict(kv_lens=np.array([n_tokens], np.int32),
                  page_indices=np.array([[1]], np.int32),
                  cu_q_lens=np.array([0, n_tokens], np.int32),
                  num_seqs=np.array([1], np.int32),
                  logits_indices=np.arange(t, dtype=np.int32))
    j = JBatch(token_ids=jnp.asarray(tok), hidden_states=None,
               positions=jnp.asarray(pos), slot_mapping=jnp.asarray(slots),
               **{k: jnp.asarray(v) for k, v in common.items()})
    p = BatchInputs(token_ids=torch.from_numpy(tok), hidden_states=None,
                    positions=torch.from_numpy(pos),
                    slot_mapping=torch.from_numpy(slots),
                    **{k: torch.from_numpy(v) for k, v in common.items()})
    return j, p


@pytest.mark.parametrize("form", ["uniform", "mixed"])
def test_stage_logits_with_lora_match_jax(form):
    """The whole stage with the adapter field, uniform and per row,
    against the JAX StageModel, f32 ``allclose``."""
    trees, js, ps = _three_adapter_sets()
    jparams, full_np = jax_params()
    jin, pin = _stage_inputs()
    if form == "uniform":
        jin = dataclasses.replace(jin, lora=js.batch_field("wide"))
        pin.lora = ps.batch_field("wide")
    else:
        slots = np.array([0, 1, 2, 3, 2, 1, 0, 3], np.int32)
        jin = dataclasses.replace(jin, lora=js.mixed_batch_field(slots))
        pin.lora = ps.mixed_batch_field(slots)
    jm = JStageModel(JCFG, 0, 4, use_pallas=False)
    want, _ = jm(jparams, jm.new_kv_caches(4, 8, jnp.float32), jin)
    pm = create_stage_model(CFG, 0, 4)
    got, _ = pm(params_from_numpy(full_np, "cpu"),
                pm.new_kv_caches(4, 8, torch.float32, "cpu"), pin)
    np.testing.assert_allclose(_np(got)[:7], np.asarray(want)[:7],
                               **ALLCLOSE)
    base, _ = pm(params_from_numpy(full_np, "cpu"),
                 pm.new_kv_caches(4, 8, torch.float32, "cpu"),
                 dataclasses.replace(pin, lora=None))
    assert np.abs(_np(base)[:7] - _np(got)[:7]).max() > 1e-3


def test_int8_tree_with_adapter_matches_jax_quantized_linear():
    """A per-request adapter over an int8 tree: the port's quantized
    product (A10's plain version on the CPU) plus the delta, against the
    JAX quantized ``linear`` with the delta, f32 ``allclose``."""
    from parallax_tpu.ops import quant as jq
    from parallax_tpu_torch.ops import quant as pq

    _, js, ps = _three_adapter_sets()
    rng = np.random.default_rng(9)
    x = rng.standard_normal((5, 64)).astype(np.float32)
    w = rng.standard_normal((128, 64)).astype(np.float32) * 0.1
    jqd = jq.quantize_param_dict(w, bits=8, group_size=32,
                                 dtype=jnp.float32)
    pqd = pq.quantize_param_dict(torch.from_numpy(w), bits=8, group_size=32,
                                 dtype=torch.float32)
    assert pq.is_quantized(pqd)
    jqd["lora"] = jlora.select_slot(js.batch_field("r4"))["0"][
        "mlp.gate_proj"]
    pqd["lora"] = lora.select_slot(ps.batch_field("r4"))["0"][
        "mlp.gate_proj"]
    np.testing.assert_allclose(
        _np(L.linear(torch.from_numpy(x), pqd)),
        np.asarray(JL.linear(jnp.asarray(x), jqd)), **ALLCLOSE)


# -- engines ----------------------------------------------------------------

def test_lora_tokens_match_offline_merge():
    """The delta-serving engine against the JAX engine (greedy rule) and
    against the port's own engine over the offline-merged weights (equal
    streams: the merge is W + s * B @ A in f32)."""
    tree = make_adapter(1, layers=[0, 2])
    (got,) = run(port_engines({"ad1": tree}), [("r", PROMPT, "ad1")])
    (jgot,) = run(jax_engines({"ad1": tree}), [("r", PROMPT, "ad1")],
                  jax_side=True)
    assert_greedy_matches(got, tree, jgot)
    merged = jax.tree.map(np.copy, jax_params()[1])
    for li, lt in tree.items():
        for path, (a, b, s) in lt.items():
            grp, proj = path.split(".")
            p = merged["layers"][li][grp][proj]
            p["weight"] = p["weight"] + s * (b @ a)
    (want,) = run(port_engines(params_np=merged), [("r", PROMPT, None)])
    assert got.output_ids == want.output_ids
    (base,) = run(port_engines(), [("b", PROMPT, None)])
    assert base.output_ids != got.output_ids


def test_base_traffic_unchanged_by_registration():
    (got,) = run(port_engines({"ad1": make_adapter(1, [0])}),
                 [("r", [5, 6, 7], None)])
    (want,) = run(port_engines(), [("r", [5, 6, 7], None)])
    assert got.output_ids == want.output_ids


def test_unknown_adapter_aborts_with_reason():
    (got,) = run(port_engines({"ad1": make_adapter(1, [0])}),
                 [("r", [1, 2, 3], "nope")])
    (jgot,) = run(jax_engines({"ad1": make_adapter(1, [0])}),
                  [("r", [1, 2, 3], "nope")], jax_side=True)
    assert got.status.value == jgot.status.value == "finished_abort"
    assert got.abort_reason == jgot.abort_reason == \
        "unknown lora adapter 'nope'"
    assert got.output_ids == []


def test_concurrent_tenants_each_get_their_adapter():
    """Three tenants (base, ad1, ad2) served by one engine each match their
    own JAX reference, and the port serves each as it serves it alone."""
    t1, t2 = make_adapter(1, [0, 1]), make_adapter(2, [1, 3])
    prompt = [1, 2, 3, 4, 5, 6]
    specs = [(f"r{i}", prompt, lid)
             for i, lid in enumerate([None, "ad1", "ad2"])]
    reqs = run(port_engines({"ad1": t1, "ad2": t2}), specs, n=6)
    jreqs = run(jax_engines({"ad1": t1, "ad2": t2}), specs, n=6,
                jax_side=True)
    for req, jreq, tree in zip(reqs, jreqs, (None, t1, t2)):
        assert_greedy_matches(req, tree, jreq)
        (solo,) = run(port_engines({"ad1": t1, "ad2": t2}),
                      [("s", prompt, req.lora_id)], n=6)
        assert req.output_ids == solo.output_ids


def test_multistage_pipeline_matches_offline_merge():
    """A two-stage delta pipeline (each stage its slice of the adapter)
    against the JAX pipeline and the single-stage port engine: downstream
    stages must not drop the batch's adapter."""
    tree = make_adapter(5, layers=[0, 1, 2, 3], scale=0.7)
    bounds = ((0, 2), (2, 4))
    (got,) = run(port_engines({"ad1": tree}, bounds), [("r", PROMPT, "ad1")],
                 n=6)
    (jgot,) = run(jax_engines({"ad1": tree}, bounds),
                  [("r", PROMPT, "ad1")], n=6, jax_side=True)
    assert_greedy_matches(got, tree, jgot)
    (one,) = run(port_engines({"ad1": tree}), [("r", PROMPT, "ad1")], n=6)
    assert got.output_ids == one.output_ids


@pytest.mark.parametrize("use_native", [False, True],
                         ids=["python-cache", "native-cache"])
def test_prefix_cache_isolates_tenants(use_native):
    """KV depends on the adapter: a tenant never prefix-hits another
    tenant's (or the base model's) pages, while same-tenant reuse works;
    the hit counts are the JAX engine's, under both cache managers."""
    from parallax_tpu_torch.runtime.engine import EngineConfig, StageEngine

    tree = make_adapter(9, layers=[0, 1])
    ads = {"ad1": tree, "ad2": make_adapter(10, [0])}
    eng = StageEngine(create_stage_model(CFG, 0, 4),
                      params_from_numpy(jax_params()[1], "cpu"),
                      EngineConfig(**ENGINE), device="cpu",
                      use_native=use_native)
    for name, t in ads.items():
        eng.load_adapter(name, t)
    (jeng,) = jax_engines(ads)
    prompt = list(range(1, 40))
    got, want = [], []
    for rid, lid in (("base1", None), ("t1a", "ad1"), ("t1b", "ad1"),
                     ("t2a", "ad2"), ("base2", None)):
        got.append(run([eng], [(rid, prompt, lid)], n=2)[0].num_cached_tokens)
        want.append(run([jeng], [(rid, prompt, lid)], n=2,
                        jax_side=True)[0].num_cached_tokens)
    assert got == want
    assert got[0] == got[1] == got[3] == 0 and got[2] > 0 and got[4] > 0


def test_pipeline_prefix_cache_with_adapters():
    """Two stages, prefix cache on: a same-adapter repeat hits the
    namespaced cache (mirror alignment included) and gives the same
    tokens; another tenant's identical prompt gets no reuse."""
    tree1 = make_adapter(4, [0, 1, 2, 3], scale=4.0)
    tree2 = make_adapter(8, [0, 2], scale=4.0)
    engines = port_engines({"ad1": tree1, "ad2": tree2}, ((0, 2), (2, 4)))
    prompt = list(range(1, 30))
    first = run(engines, [("p1", prompt, "ad1")], n=4)[0]
    again = run(engines, [("p2", prompt, "ad1")], n=4)[0]
    other = run(engines, [("p3", prompt, "ad2")], n=4)[0]
    base = run(engines, [("p4", prompt, None)], n=4)[0]
    assert first.num_cached_tokens == 0 and again.num_cached_tokens > 0
    assert again.output_ids == first.output_ids
    assert other.num_cached_tokens == 0 == base.num_cached_tokens
    assert other.output_ids != first.output_ids
    assert_greedy_matches(first, tree1)
    assert_greedy_matches(other, tree2)


def _drive(engine, specs, n):
    """The one-in-flight serving loop (``drive_step``) over one engine."""
    reqs = [Request(rid, prompt_ids=list(p), lora_id=lid,
                    sampling_params=SamplingParams(
                        temperature=0.0, max_new_tokens=n, ignore_eos=True))
            for rid, p, lid in specs]
    for r in reqs:
        engine.submit(r)
    pending = None
    for _ in range(2000):
        if not (engine.has_work() or pending is not None):
            break
        _, pending = drive_step(engine, pending)
    assert pending is None
    return reqs


MIX_SPECS = [("a", PROMPT, "ad1"), ("b", [7, 8, 9], "ad2"),
             ("c", [3, 1, 4, 1, 5, 9], None), ("d", [2, 7], "ad1")]


@pytest.mark.parametrize("k,overlap", [(1, True), (8, False), (8, True)])
def test_k1_sync_windows_and_overlap_are_bitwise(k, overlap):
    """K = 1 sync against K = 8 windows (mixed and grouped decode), with
    and without the overlapped loop: the same streams."""
    ads = {"ad1": AD1, "ad2": AD2}
    want = _drive(port_engines(ads, decode_lookahead=1,
                               overlap_steps=False)[0], MIX_SPECS, 11)
    eng = port_engines(ads, decode_lookahead=k, overlap_steps=overlap)[0]
    got = _drive(eng, MIX_SPECS, 11)
    assert [r.output_ids for r in got] == [r.output_ids for r in want]
    windows = eng.kernel_dispatch_summary()["dispatch_total"].get(
        "torch/multistep", 0)
    assert (windows > 0) == (k > 1)


def test_multistep_fused_decode_applies_adapter():
    tree = make_adapter(3, layers=[0, 1, 2, 3])
    (got,) = run(port_engines({"ad1": tree}, decode_lookahead=4),
                 [("r", PROMPT, "ad1")], n=9)
    (jgot,) = run(jax_engines({"ad1": tree}, decode_lookahead=4),
                  [("r", PROMPT, "ad1")], n=9, jax_side=True)
    assert_greedy_matches(got, tree, jgot)


def test_batch_adapter_grouping_contract():
    """Prefill batches carry exactly one adapter; pure-decode batches may
    mix, and when they do the plan says so and every tenant is served."""
    (eng,) = port_engines({"ad1": make_adapter(1, [0]),
                           "ad2": make_adapter(2, [0])})
    seen, mixed_seen = [], []
    orig = eng.scheduler.form_batch

    def spy():
        plan = orig()
        if not plan.is_empty:
            ids = {s.request.lora_id for s in plan.seqs}
            if plan.mixed_lora:
                assert len(ids) > 1
                assert all(s.num_new_tokens == 1 for s in plan.seqs)
                mixed_seen.append(ids)
            else:
                assert len(ids) == 1, f"unmarked mixed batch: {ids}"
                assert plan.lora_id in ids
            seen.extend(ids)
        return plan

    eng.scheduler.form_batch = spy
    run([eng], [(f"g{i}", [1, 2, 3], lid) for i, lid in
                enumerate([None, "ad1", "ad2", "ad1", None])], n=4)
    assert {None, "ad1", "ad2"} <= set(seen)
    assert any(len(ids) == 3 for ids in mixed_seen), mixed_seen
    assert {None, "ad1", "ad2"} <= set(seen[:6]), seen[:8]


def test_lora_id_round_trips_on_the_wire():
    from parallax_tpu.p2p.proto import ireq_from_wire as j_from_wire
    from parallax_tpu.p2p.proto import ireq_to_wire as j_to_wire
    from parallax_tpu_torch.p2p import interop, proto
    from parallax_tpu_torch.runtime.request import IntermediateRequest

    ireq = IntermediateRequest(
        request_id="x", routing_table=["a", "b"], context_len=7,
        num_new_tokens=1, token_ids=[5], lora_id="tenant-3")
    assert proto.ireq_from_wire(proto.ireq_to_wire(ireq)).lora_id == \
        "tenant-3"
    # Across packages, both ways.
    assert j_from_wire(proto.ireq_to_wire(ireq)).lora_id == "tenant-3"
    from parallax_tpu.runtime.request import IntermediateRequest as JIreq

    jireq = JIreq(request_id="x", routing_table=["a"], context_len=7,
                  num_new_tokens=1, token_ids=[5], lora_id="t")
    assert proto.ireq_from_wire(j_to_wire(jireq)).lora_id == "t"
    (back,) = interop.forward_bytes_to_ireqs(
        interop.ireqs_to_forward_bytes([ireq]))
    assert back.lora_id == "tenant-3"


# -- mixed-adapter batches ----------------------------------------------------

def _solo(lora_id, n=8, **cfg):
    (r,) = run(port_engines({"ad1": AD1, "ad2": AD2}, **cfg),
               [("s", PROMPT, lora_id)], n=n)
    return r.output_ids


def test_mixed_decode_exactly_matches_solo_runs():
    (eng,) = port_engines({"ad1": AD1, "ad2": AD2})
    mixed_plans = []
    orig = eng.scheduler.form_batch

    def spy():
        plan = orig()
        if plan.mixed_lora:
            mixed_plans.append(len(plan.seqs))
        return plan

    eng.scheduler.form_batch = spy
    specs = [("a", PROMPT, "ad1"), ("b", PROMPT, "ad2"), ("c", PROMPT, None)]
    reqs = run([eng], specs)
    jreqs = run(jax_engines({"ad1": AD1, "ad2": AD2}), specs, jax_side=True)
    assert mixed_plans and max(mixed_plans) == 3
    for r, jr, tree in zip(reqs, jreqs, (AD1, AD2, None)):
        assert r.output_ids == _solo(r.lora_id), r.request_id
        assert_greedy_matches(r, tree, jr)


def test_mixed_decode_with_multistep_window():
    specs = [("a", PROMPT, "ad1"), ("b", PROMPT, "ad2")]
    ads = {"ad1": AD1, "ad2": AD2}
    reqs = run(port_engines(ads, decode_lookahead=4), specs, n=10)
    jreqs = run(jax_engines(ads, decode_lookahead=4), specs, n=10,
                jax_side=True)
    for r, jr in zip(reqs, jreqs):
        assert r.output_ids == _solo(r.lora_id, n=10)
        assert_greedy_matches(r, ads[r.lora_id], jr)


def test_prefill_still_groups_by_adapter():
    (eng,) = port_engines({"ad1": AD1, "ad2": AD2})
    plans = []
    orig = eng.scheduler.form_batch

    def spy():
        plan = orig()
        if not plan.is_empty and any(s.num_new_tokens > 1
                                     for s in plan.seqs):
            plans.append(plan)
        return plan

    eng.scheduler.form_batch = spy
    run([eng], [("a", PROMPT, "ad1"), ("b", PROMPT, "ad2")], n=2)
    assert plans
    for plan in plans:
        assert not plan.mixed_lora
        assert len({s.request.lora_id for s in plan.seqs}) == 1


def test_budget_capped_mixed_decode_rotates_fairly():
    (eng,) = port_engines({"ad1": make_adapter(1, [0]),
                           "ad2": make_adapter(2, [0])})
    eng.scheduler.max_batch_size = 2
    reqs = run([eng], [(f"f{i}", [1, 2, 3], lid) for i, lid in
                       enumerate(["ad1", "ad1", "ad2", None])], n=6)
    for r in reqs:
        assert len(r.output_ids) == 6, r.request_id


def test_mixed_decode_with_speculation():
    """Speculation on mixed batches: the K = 1 verify plan inherits the
    mixed form and repeats each row's slot over its fed positions; a
    mixed window gets no verify width (``_spec_window_width``)."""
    (eng,) = port_engines({"ad1": AD1, "ad2": AD2}, speculative_tokens=3,
                          decode_lookahead=1)
    reqs = run([eng], [("a", PROMPT, "ad1"), ("b", PROMPT, "ad2")], n=10)
    for r in reqs:
        assert r.output_ids == _solo(r.lora_id, n=10)
    (w,) = port_engines({"ad1": AD1}, speculative_tokens=3)
    from parallax_tpu_torch.runtime.scheduler import BatchPlan

    assert w._spec_window_width(BatchPlan([], mixed_lora=True), 4) == 0
    assert w._spec_window_width(BatchPlan([], lora_id="ad1"), 4) == 3
    specs = [("a", PROMPT, "ad1"), ("b", PROMPT, "ad2")]
    ads = {"ad1": AD1, "ad2": AD2}
    reqs = run(port_engines(ads, speculative_tokens=3), specs, n=10)
    jreqs = run(jax_engines(ads, speculative_tokens=3), specs, n=10,
                jax_side=True)
    for r, jr in zip(reqs, jreqs):
        assert r.output_ids == _solo(r.lora_id, n=10)
        assert_greedy_matches(r, ads[r.lora_id], jr)


# -- port-only: graphs, re-stacks, the null slot ------------------------------

class _ReplayGraphs:
    """A CPU stand-in for ``runtime/step_graph.WindowGraphs`` with a graph's
    freezing: a key's FIRST step callable and a clone of its first state
    are kept, and every later window of the key copies its state into that
    clone and runs the kept callable. So whatever the first window's step
    closed over (a Python slot, say) replays for every later window, as in
    a captured CUDA graph, while what it reads from the state follows."""

    def __init__(self):
        self._graphs = {}
        self.replays = 0
        self.on_capture = None
        self.capture_s = 0.0
        self.capture_parts_s = {}
        self.warmup_launches = {}
        self.pool_bytes = 0
        self.dropped = 0

    @property
    def captured(self):
        return len(self._graphs)

    def drop(self, pred):
        keys = [k for k in self._graphs if pred(k)]
        for k in keys:
            del self._graphs[k]
        self.dropped += len(keys)
        return len(keys)

    def run(self, key, state, step, n, preserve=None):
        entry = self._graphs.get(key)
        if entry is None:
            entry = self._graphs[key] = (step, state.clone())
            if self.on_capture is not None:
                self.on_capture(key, 0.0)
        else:
            entry[1].copy_(state)
        for _ in range(n):
            entry[0](entry[1])
        self.replays += n
        return entry[1]


def _graph_engine(ads, **cfg):
    (eng,) = port_engines(ads, decode_lookahead=4, overlap_steps=False,
                          max_batch_size=1, **cfg)
    eng._graphs = _ReplayGraphs()
    # The engine's compile observatory hears each capture, as from
    # WindowGraphs.
    eng._graphs.on_capture = eng._on_graph_capture
    return eng


def test_graph_window_switches_adapters_between_windows():
    """One graph key serves whichever adapter its window carries: ad1's
    request, then ad2's, then base, one at a time at the same shapes, each
    equal to its stream without graphs."""
    ads = {"ad1": AD1, "ad2": AD2}
    eng = _graph_engine(ads)
    got = [_drive(eng, [(f"r{lid}", PROMPT, lid)], 9)[0].output_ids
           for lid in ("ad1", "ad2", None, "ad1")]
    keys = list(eng._graphs._graphs)
    # ad1 and ad2 share one key (uniform form, same generation); base has
    # its own.
    assert len(keys) == 2 and eng._graphs.replays > 0
    for lid, toks in zip(("ad1", "ad2", None, "ad1"), got):
        assert toks == _solo(lid, n=9)
    assert got[0] != got[1]


def test_restack_after_capture_drops_the_older_graphs():
    """A register after capture re-stacks the adapters into new tensors:
    the graphs captured over the old stack go (base graphs stay), and the
    new adapter serves its own stream."""
    eng = _graph_engine({"ad1": AD1})
    _drive(eng, [("a", PROMPT, "ad1")], 9)
    _drive(eng, [("b", PROMPT, None)], 9)
    assert eng._graphs.captured == 2
    gen = eng._adapters.generation
    eng.load_adapter("ad2", AD2)
    (r,) = _drive(eng, [("c", PROMPT, "ad2")], 9)
    assert eng._adapters.generation == gen + 1
    assert eng._graphs.dropped == 1 and eng._graphs.captured == 2
    assert r.output_ids == _solo("ad2", n=9)
    (r,) = _drive(eng, [("d", PROMPT, "ad1")], 9)
    assert r.output_ids == _solo("ad1", n=9)


def test_lru_eviction_serves_the_newcomer_and_keeps_active():
    """``lora_max_adapters``: registering past the cap evicts an idle
    adapter (never one with a request in flight), and the new adapter
    serves its own stream."""
    ad3 = make_adapter(21, [0, 1, 2, 3])
    (eng,) = port_engines({"ad1": AD1, "ad2": AD2}, lora_max_adapters=2)
    run([eng], [("a", PROMPT, "ad1")], n=2)
    held = Request("held", prompt_ids=list(PROMPT), lora_id="ad2",
                   sampling_params=SamplingParams(temperature=0.0,
                                                  max_new_tokens=4,
                                                  ignore_eos=True))
    eng.submit(held)
    eng.load_adapter("ad3", ad3)
    assert eng.adapter_names() == ["ad2", "ad3"]
    reqs = run([eng], [("c", PROMPT, "ad3")], n=6)
    assert held.status.is_finished and len(held.output_ids) == 4
    assert_greedy_matches(reqs[0], ad3)


def test_null_slot_on_a_non_head_stage():
    """A mixed batch on a stage without token ids (the second of two
    stages, fed hidden states): the engine sizes the slot vector by the
    bucket's token rows (padding and base rows hold the null slot, which
    ``F.one_hot`` would refuse), and each row's logits are those of the
    same row under its own adapter alone (f32 ``allclose``)."""
    import types

    from parallax_tpu_torch.runtime.scheduler import BatchPlan

    ads = {"ad1": make_adapter(1, [0, 1, 2, 3], scale=4.0),
           "ad2": make_adapter(2, [0, 1, 2, 3], scale=4.0)}
    eng = port_engines(ads, ((0, 2), (2, 4)))[1]
    lids = ["ad1", None, "ad2"]
    plan = BatchPlan([types.SimpleNamespace(
        num_new_tokens=1, request=types.SimpleNamespace(lora_id=lid))
        for lid in lids], mixed_lora=True)
    t = 4                                    # the token bucket: one pad row
    rng = np.random.default_rng(4)
    hidden = torch.from_numpy(
        rng.standard_normal((t, RAW["hidden_size"])).astype(np.float32))

    def inputs():
        return BatchInputs(
            token_ids=None, hidden_states=hidden,
            positions=torch.zeros(t, dtype=torch.int32),
            kv_lens=torch.ones(3, dtype=torch.int32),
            page_indices=torch.tensor([[1], [2], [3]], dtype=torch.int32),
            cu_q_lens=torch.tensor([0, 1, 2, 3], dtype=torch.int32),
            num_seqs=torch.tensor([3], dtype=torch.int32),
            slot_mapping=torch.tensor([8, 16, 24, -1], dtype=torch.int32),
            logits_indices=torch.arange(3, dtype=torch.int32))

    def forward(inp):
        kv = eng.model.new_kv_caches(4, 8, torch.float32, "cpu")
        return eng.model(eng.params, kv, inp)[0]

    mixed = inputs()
    mixed.lora = eng._lora_field(plan, mixed)
    assert mixed.lora["slots"].tolist() == [0, 2, 1, 2]
    got = forward(mixed)
    for row, lid in enumerate(lids):
        solo = inputs()
        if lid is not None:
            solo.lora = eng._adapters.batch_field(lid)
        np.testing.assert_allclose(_np(got[row]), _np(forward(solo)[row]),
                                   **ALLCLOSE)
    # The adapter moved its row.
    assert (got[0] - forward(inputs())[0]).abs().max() > 1e-3


# -- merges: load time, offline, DoRA, quantized targets ----------------------

PERIPHERY = dict(
    architectures=["Qwen2ForCausalLM"], hidden_size=32, num_hidden_layers=2,
    num_attention_heads=4, num_key_value_heads=2, intermediate_size=64,
    vocab_size=97, max_position_embeddings=128, tie_word_embeddings=False,
)


def _periphery_ckpt(tmp_path, key=0):
    """A tiny f32 checkpoint from JAX ``init_params``, written with the
    port's writer; returns (dir, JAX model, port model)."""
    from parallax_tpu.config import normalize_config as jn
    from parallax_tpu_torch.config import normalize_config as pn
    from parallax_tpu_torch.utils.st_writer import write_checkpoint

    jm = JStageModel(jn(PERIPHERY), 0, 2, use_pallas=False)
    params = jax.tree.map(np.asarray, jm.init_params(jax.random.key(key),
                                                     dtype=jnp.float32))
    tensors = {}

    def walk(prefix, node):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(f"{prefix}.{k}" if prefix else k, v)
        elif isinstance(node, list):
            for i, v in enumerate(node):
                walk(f"{prefix}.{i}", v)
        else:
            name = prefix if prefix.startswith("lm_head") else \
                f"model.{prefix}"
            tensors[name] = torch.from_numpy(np.array(node))

    walk("", params)
    path = str(tmp_path / "base")
    write_checkpoint(tensors, PERIPHERY, path)
    return path, jm, create_stage_model(pn(PERIPHERY), 0, 2)


def _periphery_adapter(tmp_path, dora=False, rank=2):
    rng = np.random.default_rng(7)
    tree = {0: {"self_attn.q_proj": (
                rng.normal(size=(rank, 32)).astype(np.float32) * 0.3,
                rng.normal(size=(32, rank)).astype(np.float32) * 0.3, 1.0)},
            1: {"mlp.down_proj": (
                rng.normal(size=(rank, 64)).astype(np.float32) * 0.3,
                rng.normal(size=(32, rank)).astype(np.float32) * 0.3, 1.0)}}
    mags = None
    if dora:
        mags = {"base_model.model.model.layers.0.self_attn.q_proj":
                rng.normal(size=32).astype(np.float32) * 0.1 + 1.0}
    return _write_peft(tmp_path / ("dora" if dora else "lora"), tree,
                       rank=rank, alpha=4.0, dora=mags)


def _assert_trees_close(got, want):
    g, w = jax.tree.leaves(got), jax.tree.leaves(want)
    assert len(g) == len(w)
    for a, b in zip(g, w):
        np.testing.assert_allclose(_np(a), np.asarray(b), **ALLCLOSE)


@pytest.mark.parametrize("dora", [False, True], ids=["lora", "dora"])
def test_load_time_and_offline_merges_match_jax(tmp_path, dora):
    """``load_stage_params(lora_path=)`` and ``merge_adapter`` (the
    ``lora-merge`` command's) against the JAX loader's and the JAX
    tool's, and against each other, f32 ``allclose``; DoRA rows carry the
    learned magnitudes."""
    from parallax_tpu.models import loader as jloader
    from parallax_tpu.utils.adapter import merge_adapter as j_merge
    from parallax_tpu_torch.models import loader as ploader
    from parallax_tpu_torch.utils.adapter import merge_adapter

    base, jm, pm = _periphery_ckpt(tmp_path)
    ad = _periphery_adapter(tmp_path, dora=dora)
    via_load = ploader.load_stage_params(pm, base, dtype=torch.float32,
                                         device="cpu", lora_path=ad)
    jvia_load = jloader.load_stage_params(jm, base, dtype=jnp.float32,
                                          lora_path=ad)
    _assert_trees_close(via_load, jvia_load)
    out, jout = str(tmp_path / "merged"), str(tmp_path / "jmerged")
    assert merge_adapter(base, ad, out) == j_merge(base, ad, jout) == 2
    assert os.path.exists(os.path.join(out, "config.json"))
    via_tool = ploader.load_stage_params(pm, out, dtype=torch.float32,
                                         device="cpu")
    _assert_trees_close(via_tool, jloader.load_stage_params(
        jm, jout, dtype=jnp.float32))
    _assert_trees_close(via_tool, jax.tree.map(_np, via_load))
    plain = ploader.load_stage_params(pm, base, dtype=torch.float32,
                                      device="cpu")
    q0 = via_tool["layers"][0]["self_attn"]["q_proj"]["weight"]
    assert (q0 - plain["layers"][0]["self_attn"]["q_proj"]["weight"]
            ).abs().max() > 1e-3
    if dora:
        from parallax_tpu_torch.models.loader import SafetensorsFile

        st = SafetensorsFile(os.path.join(ad, "adapter_model.safetensors"))
        mag = st.get_tensor(
            "base_model.model.model.layers.0.self_attn.q_proj."
            "lora_magnitude_vector.weight")
        np.testing.assert_allclose(_np(torch.linalg.vector_norm(q0, dim=1)),
                                   _np(mag), **ALLCLOSE)


def test_lora_merge_respects_stage_range(tmp_path):
    from parallax_tpu_torch.models.loader import apply_lora_adapter

    base, jm, pm = _periphery_ckpt(tmp_path)
    ad = _periphery_adapter(tmp_path)
    from parallax_tpu_torch.config import normalize_config as pn

    stage = create_stage_model(pn(PERIPHERY), 1, 2)     # layer 1 only
    params = stage.init_params(torch.Generator().manual_seed(0),
                               torch.float32, "cpu")
    assert apply_lora_adapter(stage, params, ad, torch.float32) == 1
    params = pm.init_params(torch.Generator().manual_seed(0),
                            torch.float32, "cpu")
    assert apply_lora_adapter(pm, params, ad, torch.float32) == 2


def test_lora_rejects_quantized_target(tmp_path):
    """A target already quantized is refused (the JAX loader's error):
    merge in full precision, then quantize on load."""
    from parallax_tpu_torch.models import loader as ploader
    from parallax_tpu_torch.models.loader import apply_lora_adapter
    from parallax_tpu_torch.ops.quant import quantize_tree

    base, _, pm = _periphery_ckpt(tmp_path)
    ad = _periphery_adapter(tmp_path)
    params = quantize_tree(pm.init_params(torch.Generator().manual_seed(0),
                                          torch.float32, "cpu"),
                           bits=8, group_size=16, dtype=torch.float32)
    with pytest.raises(ValueError, match="quantized"):
        apply_lora_adapter(pm, params, ad, torch.float32)
    # The loader merges first and quantizes after.
    tree = ploader.load_stage_params(pm, base, dtype=torch.float32,
                                     device="cpu", lora_path=ad,
                                     quantize="int8")
    assert "qweight" in tree["layers"][1]["mlp"]["down_proj"]


def test_merged_checkpoint_serves_like_the_per_request_adapter(tmp_path):
    """The ``lora-merge`` command's output loads and serves the same greedy
    stream as the base checkpoint with the adapter applied per request."""
    from parallax_tpu_torch import cli
    from parallax_tpu_torch.config import normalize_config as pn
    from parallax_tpu_torch.models import loader as ploader
    from parallax_tpu_torch.runtime.engine import EngineConfig, StageEngine
    from parallax_tpu_torch.runtime.pipeline import InProcessPipeline

    base, _, pm = _periphery_ckpt(tmp_path, key=3)
    ad = _periphery_adapter(tmp_path)
    out = str(tmp_path / "cli-merged")
    assert cli.main(["lora-merge", "--model-path", base, "--adapter-path", ad,
                     "--out-dir", out]) == 0
    ecfg = EngineConfig(**ENGINE)

    def serve(path, lid=None):
        eng = StageEngine(pm, ploader.load_stage_params(
            pm, path, dtype=torch.float32, device="cpu"), ecfg, device="cpu")
        if lid:
            eng.load_adapter(lid, ad)
        pipe = InProcessPipeline([eng])
        r = Request("r", prompt_ids=[3, 1, 4, 1, 5], lora_id=lid,
                    sampling_params=SamplingParams(temperature=0.0,
                                                   max_new_tokens=8,
                                                   ignore_eos=True))
        pipe.submit(r)
        pipe.run_until_complete()
        return r.output_ids

    assert serve(out) == serve(base, "t") != serve(base)
    with open(os.path.join(out, "config.json")) as f:
        assert json.load(f) == PERIPHERY
    assert pn(PERIPHERY).num_hidden_layers == 2


# -- parked, migrated and resumed adapter requests ----------------------------

def test_preempted_adapter_rows_resume_under_their_adapter():
    """The host KV tier under pressure with adapter rows: rows park to the
    tier and resume under their adapter and namespace, the streams equal
    those of a pool with room for every row."""
    ads = {"ad1": AD1, "ad2": AD2}
    specs = [(f"p{i}", [3 + i] * 12, ("ad1", "ad2", None)[i % 3])
             for i in range(6)]
    (tight,) = port_engines(ads, num_pages=22, host_cache_bytes=1 << 24,
                            max_model_len=256)
    got = _drive(tight, specs, 24)
    stats = tight.cache_stats()
    assert stats["preemptions"] > 0 and stats["kv_oom_aborts"] == 0
    (roomy,) = port_engines(ads, max_model_len=256)
    want = _drive(roomy, specs, 24)
    assert [r.output_ids for r in got] == [r.output_ids for r in want]


def test_checkpoint_resumes_under_the_adapter_and_its_namespace():
    """A checkpoint (migration, handoff) carries the adapter: the resumed
    request serves under it, and a KV adoption matches the prefix in the
    adapter's namespace only."""
    from parallax_tpu_torch.runtime.checkpoint import (
        build_resumed_request,
        checkpoint_from_request,
        checkpoint_from_wire,
        checkpoint_to_wire,
    )

    (eng,) = port_engines({"ad1": AD1})
    prompt = list(range(1, 30))
    (donor,) = _drive(eng, [("d", prompt, "ad1")], 4)
    ck = checkpoint_from_wire(checkpoint_to_wire(
        checkpoint_from_request(donor)))
    resumed = build_resumed_request(ck, replay=True)
    assert ck.lora_id == resumed.lora_id == "ad1"
    # Pages donated under ad1 cover the migrated prefix for ad1 only (the
    # Python manager: the one with the host tier's adoption).
    from parallax_tpu_torch.runtime.cache_manager import CacheManager
    from parallax_tpu_torch.runtime.request import RequestStatus

    cache = CacheManager(page_size=8, num_pages=64)
    d = Request("d", prompt_ids=list(prompt), lora_id="ad1",
                sampling_params=SamplingParams())
    assert cache.allocate_for_prompt(d)
    d.num_computed_tokens = len(prompt)
    d.status = RequestStatus.FINISHED_EOS
    cache.release(d)
    for lid, want in (("ad1", True), (None, False), ("ad2", False)):
        r = Request(f"m_{lid}", prompt_ids=list(prompt), lora_id=lid,
                    sampling_params=SamplingParams())
        assert cache.adopt_migrated(r, [], 24) is want
