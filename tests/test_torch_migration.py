"""The port's live migration (``parallax_tpu_torch/runtime/checkpoint.py``,
the engine's extract / harvest / adopt, the scheduler's migration targets
and ``where_is``, and the worker's checkpoint RPC) against
``parallax_tpu``, on the CPU, as tests/test_churn_migration.py holds the
JAX package.

- The checkpoint wire form round trips with and without a KV image; every
  corrupt or truncated frame of the JAX fuzz list raises
  ``CheckpointError`` in the port, as in JAX.
- A resumed request folds its outputs and counts from the original stream
  position; a re-checkpoint never nests.
- Engine to engine: a request parked mid-decode, harvested, framed,
  decoded and adopted continues bit-identically (greedy and seeded), with
  no re-prefill; a layout mismatch refuses the image and the replay rung
  reproduces the stream.
- Across packages: a JAX engine's checkpoint, framed by
  ``parallax_tpu.p2p.proto``, is decoded and adopted by a port engine, and
  a port checkpoint framed by the port's codec by a JAX engine; each
  stream equals the adopting package's uninterrupted stream, and the
  frame bytes equal the other package's encoding of the same checkpoint.
- The scheduler picks the warm replica as the JAX one does and answers
  ``where_is``; grammar checkpoints restore the DFA state only under a
  matching hash.
- A worker serves ``rpc_checkpoint`` (accepting, restoring, rejecting a
  corrupt frame) and ``chat_submit`` with ``replay_ids``.
"""

import dataclasses
import json
import time

import numpy as np
import pytest
import torch

from parallax_tpu.p2p import proto as jproto
from parallax_tpu.runtime import checkpoint as jck
from parallax_tpu.runtime.engine import EngineConfig as JEngineConfig
from parallax_tpu.runtime.engine import StageEngine as JStageEngine
from parallax_tpu.runtime.engine import drive_step as j_drive_step
from parallax_tpu.runtime.request import Request as JRequest
from parallax_tpu.runtime.request import SamplingParams as JSampling
from parallax_tpu.scheduling.scheduler import GlobalScheduler as JScheduler
from parallax_tpu.utils.hw import HardwareInfo as JHardwareInfo
from parallax_tpu.models.base import StageModel as JStageModel
from parallax_tpu_torch.config import normalize_config
from parallax_tpu_torch.constrained import grammar_state_hash
from parallax_tpu_torch.models import create_stage_model, params_from_numpy
from parallax_tpu_torch.p2p import proto, wire
from parallax_tpu_torch.p2p.node import WorkerNode
from parallax_tpu_torch.p2p.transport import LoopbackTransport
from parallax_tpu_torch.runtime.checkpoint import (
    CheckpointError,
    KVImage,
    RequestCheckpoint,
    build_resumed_request,
    checkpoint_from_request,
    checkpoint_from_wire,
    checkpoint_to_wire,
)
from parallax_tpu_torch.runtime.engine import (
    EngineConfig,
    StageEngine,
    drive_step,
)
from parallax_tpu_torch.runtime.radix_cache import block_hash_chain
from parallax_tpu_torch.runtime.request import (
    Request,
    RequestStatus,
    SamplingParams,
)
from parallax_tpu_torch.scheduling.scheduler import GlobalScheduler
from parallax_tpu_torch.utils.hw import HardwareInfo
from tests.test_torch_engine import TINY_QWEN2, _weights


def wait_for(cond, timeout=10.0, interval=0.01):
    end = time.monotonic() + timeout
    while time.monotonic() < end:
        if cond():
            return True
        time.sleep(interval)
    return False


# -- checkpoint wire format ------------------------------------------------


def _layers(np_out=False):
    rng = np.random.default_rng(3)
    arrs = [rng.standard_normal((2, 2, 4, 2, 8), dtype=np.float32)
            for _ in range(2)]
    return arrs if np_out else [torch.from_numpy(a) for a in arrs]


def _mk_ckpt(with_kv=True, n_out=5, pkg="port"):
    """The JAX test's checkpoint, built in either package."""
    m = jck if pkg == "jax" else None
    kv_cls, ck_cls, sp_cls = (
        (m.KVImage, m.RequestCheckpoint, JSampling) if m
        else (KVImage, RequestCheckpoint, SamplingParams))
    kv = None
    if with_kv:
        kv = kv_cls(
            page_size=4, start_layer=0, end_layer=2, kv_dtype="float32",
            prefix_tokens=4, computed_tokens=4 + 8,
            layers=_layers(np_out=m is not None),
        )
    return ck_cls(
        request_id="ck-1",
        prompt_ids=[5, 6, 7, 8, 9, 10, 11],
        output_ids=list(range(20, 20 + n_out)),
        output_logprobs=[-0.5] * n_out,
        sampling_params=sp_cls(
            temperature=0.8, top_k=8, seed=42, max_new_tokens=32,
        ).to_dict(),
        eos_token_ids=[0],
        lora_id=None,
        routing_table=["w2", "w3"],
        age_s=1.25,
        parked_wall=123.0,
        traced=True,
        kv=kv,
    )


class TestCheckpointWire:
    def test_roundtrip_with_kv(self):
        ck = _mk_ckpt()
        # Through the port's msgpack codec: the frame survives real
        # serialization.
        back = checkpoint_from_wire(
            wire.unpackb(wire.packb(checkpoint_to_wire(ck))))
        assert back.request_id == ck.request_id
        assert back.prompt_ids == ck.prompt_ids
        assert back.output_ids == ck.output_ids
        assert back.output_logprobs == ck.output_logprobs
        assert back.routing_table == ck.routing_table
        assert back.traced is True
        assert back.kv is not None
        assert back.kv.signature == ck.kv.signature
        assert back.kv.prefix_tokens == 4
        for a, b in zip(back.kv.layers, ck.kv.layers):
            assert a.dtype == b.dtype and torch.equal(a, b)

    def test_roundtrip_without_kv(self):
        ck = _mk_ckpt(with_kv=False)
        back = checkpoint_from_wire(checkpoint_to_wire(ck))
        assert back.kv is None
        assert back.output_ids == ck.output_ids

    def test_frame_bytes_and_signature_equal_jax(self):
        """The same checkpoint frames to the same bytes in both packages,
        and its KV signature (dtype names included) is the JAX one."""
        for kv in (True, False):
            p = proto.encode_frame(proto.CHECKPOINT, {"checkpoints": [
                checkpoint_to_wire(_mk_ckpt(with_kv=kv))]})
            j = jproto.encode_frame(jproto.CHECKPOINT, {"checkpoints": [
                jck.checkpoint_to_wire(_mk_ckpt(with_kv=kv, pkg="jax"))]})
            assert p == j
        assert (_mk_ckpt().kv.signature
                == _mk_ckpt(pkg="jax").kv.signature)

    @pytest.mark.parametrize("mutate,desc", [
        (lambda d: d.update(v=99), "bad version"),
        (lambda d: d.pop("rid"), "missing rid"),
        (lambda d: d.update(rid=7), "non-string rid"),
        (lambda d: d.update(prompt_ids=[]), "empty prompt"),
        (lambda d: d.update(prompt_ids="abc"), "prompt not a list"),
        (lambda d: d.update(prompt_ids=[1, "x"]), "non-int token"),
        (lambda d: d.update(prompt_ids=list(range(1 << 20 | 1))),
         "oversized prompt"),
        (lambda d: d.update(
            output_logprobs=[-0.1] * (len(d["output_ids"]) + 1)
        ), "more logprobs than tokens"),
        (lambda d: d.update(sampling_params=[1, 2]),
         "sampling_params not a map"),
        (lambda d: d.update(routing_table=[1]), "routing table non-str"),
        (lambda d: d["kv"].update(page_size=0), "zero page size"),
        (lambda d: d["kv"].update(prefix_tokens=3),
         "prefix not page aligned"),
        (lambda d: d["kv"].update(prefix_tokens=99999,
                                  computed_tokens=99999 + 8),
         "kv covers more than checkpoint"),
        (lambda d: d["kv"].update(layers=[]), "kv with no layers"),
        (lambda d: d["kv"]["layers"].__setitem__(0, {"bogus": 1}),
         "malformed layer tensor"),
        (lambda d: d["kv"]["layers"][0].update(
            data=d["kv"]["layers"][0]["data"][:-8]
        ), "truncated layer bytes"),
        (lambda d: d["kv"]["layers"][0].update(data=b""),
         "empty layer bytes"),
        (lambda d: d["kv"]["layers"][1].update(
            shape=[3] + list(d["kv"]["layers"][1]["shape"])[1:]
        ), "layers disagree on page count"),
        (lambda d: d["kv"].update(computed_tokens=4),
         "empty image token span"),
    ])
    def test_corrupt_frames_rejected(self, mutate, desc):
        """Each corrupt frame raises CheckpointError in the port, and the
        same mutation of the JAX package's frame raises in JAX."""
        d = checkpoint_to_wire(_mk_ckpt())
        mutate(d)
        with pytest.raises(CheckpointError):
            checkpoint_from_wire(d)
        jd = jck.checkpoint_to_wire(_mk_ckpt(pkg="jax"))
        mutate(jd)
        with pytest.raises(jck.CheckpointError):
            jck.checkpoint_from_wire(jd)
        # A clean frame still parses (the case poisoned no shared state).
        checkpoint_from_wire(checkpoint_to_wire(_mk_ckpt()))

    def test_truncated_page_count_rejected(self):
        d = checkpoint_to_wire(_mk_ckpt())
        # 8 image tokens at page_size 4 need 2 pages (+1 slack): claim 16
        # tokens over the same 2 pages -> under-coverage.
        d["kv"]["computed_tokens"] = 4 + 16
        d["prompt_ids"] = list(range(1, 40))
        with pytest.raises(CheckpointError, match="do not cover"):
            checkpoint_from_wire(d)


# -- resumed-request accounting --------------------------------------------


class TestResumedRequest:
    def _req(self, n_out=4, **sp):
        req = Request(
            "r1", prompt_ids=[1, 2, 3],
            sampling_params=SamplingParams(
                max_new_tokens=sp.pop("max_new_tokens", 10), **sp
            ),
        )
        for i in range(n_out):
            req.status = RequestStatus.DECODING
            req.commit_token(50 + i, logprob=-0.25 * i)
        return req

    def test_fold_and_offsets(self):
        ck = checkpoint_from_request(self._req(), routing_table=["w9"])
        res = build_resumed_request(ck)
        assert res.prompt_ids == [1, 2, 3, 50, 51, 52, 53]
        assert res.output_ids == []
        assert res.output_offset == 4
        assert res.num_generated == 4
        assert res.full_output_ids == [50, 51, 52, 53]
        assert res.prior_output_ids == [50, 51, 52, 53]
        assert res.full_output_logprobs == [0.0, -0.25, -0.5, -0.75]
        assert res.routing_table == ["w9"]

    def test_budgets_count_from_original_position(self):
        res = build_resumed_request(
            checkpoint_from_request(self._req(n_out=4, max_new_tokens=6))
        )
        res.status = RequestStatus.DECODING
        res.commit_token(60)
        assert not res.status.is_finished
        res.commit_token(61)          # 4 folded + 2 fresh = budget of 6
        assert res.status is RequestStatus.FINISHED_LENGTH
        assert res.full_output_ids == [50, 51, 52, 53, 60, 61]

    def test_min_new_gate_counts_folded_tokens(self):
        req = self._req(n_out=3, max_new_tokens=10)
        req.sampling_params.min_new_tokens = 2
        req.eos_token_ids = (99,)
        res = build_resumed_request(checkpoint_from_request(req))
        res.eos_token_ids = (99,)
        res.status = RequestStatus.DECODING
        res.commit_token(99)   # min_new already satisfied by folded tokens
        assert res.status is RequestStatus.FINISHED_EOS

    def test_recheckpoint_never_nests(self):
        res = build_resumed_request(
            checkpoint_from_request(self._req(n_out=4))
        )
        res.status = RequestStatus.DECODING
        res.commit_token(60, logprob=-1.0)
        ck2 = checkpoint_from_request(res)
        assert ck2.prompt_ids == [1, 2, 3]
        assert ck2.output_ids == [50, 51, 52, 53, 60]
        assert len(ck2.output_logprobs) == 5
        res2 = build_resumed_request(ck2)
        assert res2.prompt_ids == [1, 2, 3, 50, 51, 52, 53, 60]
        assert res2.output_offset == 5


# -- engine to engine ---------------------------------------------------------

ENGINE = dict(page_size=8, num_pages=64, max_model_len=256,
              kv_dtype="float32", host_cache_bytes=1 << 24)
PROMPT = [3, 5, 7, 11, 13, 17, 19, 23] * 2


def _port_engine(**over):
    cfg = normalize_config(TINY_QWEN2)
    return StageEngine(create_stage_model(cfg, 0, 4),
                       params_from_numpy(_weights(TINY_QWEN2)[2], "cpu"),
                       EngineConfig(**dict(ENGINE, **over)), device="cpu")


def _jax_engine(**over):
    jcfg, full, _ = _weights(TINY_QWEN2)
    return JStageEngine(JStageModel(jcfg, 0, 4, use_pallas=False), full,
                        JEngineConfig(**dict(ENGINE, **over)))


def _drive(eng, step=drive_step, n_guard=5000):
    pending, guard = None, 0
    while (eng.has_work() or pending is not None) and guard < n_guard:
        guard += 1
        _outs, pending = step(eng, pending)
    assert guard < n_guard


def _drive_tokens(eng, req, n_tokens, step=drive_step, n_guard=5000):
    """Drive until the request committed >= n_tokens, then resolve the
    in-flight step WITHOUT dispatching another (the row is extractable)."""
    pending, guard = None, 0
    while len(req.output_ids) < n_tokens and guard < n_guard:
        guard += 1
        _outs, pending = step(eng, pending)
    if pending is not None:
        eng.resolve(pending)
    assert guard < n_guard


def _baseline(eng, req_cls, sp, step=drive_step):
    base = req_cls("base", prompt_ids=list(PROMPT),
                   sampling_params=dataclasses.replace(sp))
    eng.submit(base)
    _drive(eng, step)
    assert base.status.is_finished and len(base.output_ids) == 16
    return base


def _park(eng, req_cls, sp, ck_mod, n_tokens=6, step=drive_step):
    """Run to mid-decode, park to host, harvest, extract, checkpoint."""
    mig = req_cls("mig", prompt_ids=list(PROMPT),
                  sampling_params=dataclasses.replace(sp))
    eng.submit(mig)
    _drive_tokens(eng, mig, n_tokens, step)
    assert not mig.status.is_finished
    assert eng.cache.preempt_to_host(mig)
    image = eng.harvest_kv_image(mig)
    assert image is not None and image.computed_tokens > 0
    assert eng.extract("mig") is mig
    ckpt = ck_mod.checkpoint_from_request(mig, routing_table=["B"],
                                          kv=image)
    eng.cache.release(mig)
    return ckpt


class _PortCk:
    checkpoint_from_request = staticmethod(checkpoint_from_request)


@pytest.mark.parametrize("sp_kw", [
    dict(temperature=0.0),
    dict(temperature=0.8, top_k=8, seed=1234),
], ids=["greedy", "seeded"])
def test_kv_image_migration_bit_identical(sp_kw):
    """Park mid-decode on A, harvest the pinned host image, send the
    checkpoint through the real frame bytes, adopt on B (same layout),
    resume: the continuation matches an uninterrupted run token for
    token, with no re-prefill."""
    sp = SamplingParams(max_new_tokens=16, ignore_eos=True, **sp_kw)
    base = _baseline(_port_engine(), Request, sp)
    ckpt = _park(_port_engine(), Request, sp, _PortCk)
    frame = proto.decode_frame(proto.encode_frame(
        proto.CHECKPOINT, {"checkpoints": [checkpoint_to_wire(ckpt)]}))
    got = checkpoint_from_wire(frame["p"]["checkpoints"][0])
    eng_b = _port_engine()
    res = build_resumed_request(got)
    assert got.kv is not None
    assert eng_b.adopt_checkpoint_kv(res, got.kv)
    assert res.status is RequestStatus.PREEMPTED
    assert eng_b.submit(res)
    _drive(eng_b)
    assert res.status.is_finished
    # The image swap-in covered the whole committed context.
    assert eng_b.cache.stats.resumes == 1
    assert eng_b.cache.stats.tokens_admitted == 0
    assert res.full_output_ids == base.output_ids
    assert res.status == base.status


def test_adopt_falls_back_cleanly_on_layout_mismatch():
    """A target with another page size (another signature) or without a
    host tier refuses the image, untouched; the replay rung reproduces
    the stream."""
    sp = SamplingParams(temperature=0.0, max_new_tokens=16, ignore_eos=True)
    ckpt = _park(_port_engine(), Request, sp, _PortCk, n_tokens=5)
    mismatch = _port_engine(page_size=4, num_pages=128)
    res = build_resumed_request(ckpt)
    assert not mismatch.adopt_checkpoint_kv(res, ckpt.kv)
    assert res.status is not RequestStatus.PREEMPTED
    eng_b = _port_engine(host_cache_bytes=0)
    assert not eng_b.adopt_checkpoint_kv(res, ckpt.kv)
    res = build_resumed_request(ckpt, replay=True)
    assert res.prompt_ids == PROMPT
    assert res.replay_ids == list(ckpt.output_ids)
    assert len(res.replay_ids) >= 5
    assert eng_b.submit(res)
    _drive(eng_b)
    assert res.status.is_finished and res.replay_ids == []
    base = _baseline(_port_engine(), Request, sp)
    assert res.full_output_ids == base.output_ids


GREEDY = dict(temperature=0.0, max_new_tokens=16, ignore_eos=True)


def test_jax_checkpoint_adopted_by_port_engine():
    """A JAX engine's harvested checkpoint, framed by the JAX codec, is
    decoded and adopted by a port engine; the stream equals the port's
    uninterrupted one, and the port re-frames it to the same bytes."""
    ckpt = _park(_jax_engine(), JRequest, JSampling(**GREEDY), jck,
                 step=j_drive_step)
    data = jproto.encode_frame(jproto.CHECKPOINT, {"checkpoints": [
        jck.checkpoint_to_wire(ckpt)]})
    got = checkpoint_from_wire(proto.decode_frame(data)["p"]
                               ["checkpoints"][0])
    assert proto.encode_frame(proto.CHECKPOINT, {"checkpoints": [
        checkpoint_to_wire(got)]}) == data
    eng = _port_engine()
    res = build_resumed_request(got)
    assert eng.adopt_checkpoint_kv(res, got.kv)
    assert eng.submit(res)
    _drive(eng)
    assert eng.cache.stats.resumes == 1
    base = _baseline(_port_engine(), Request, SamplingParams(**GREEDY))
    assert res.full_output_ids == base.output_ids


def test_port_checkpoint_adopted_by_jax_engine():
    """The other way: a port checkpoint framed by the port's codec is
    decoded and adopted by a JAX engine; the stream equals the JAX
    engine's uninterrupted one, and JAX re-frames it to the same bytes."""
    ckpt = _park(_port_engine(), Request, SamplingParams(**GREEDY), _PortCk)
    data = proto.encode_frame(proto.CHECKPOINT, {"checkpoints": [
        checkpoint_to_wire(ckpt)]})
    got = jck.checkpoint_from_wire(jproto.decode_frame(data)["p"]
                                   ["checkpoints"][0])
    assert jproto.encode_frame(jproto.CHECKPOINT, {"checkpoints": [
        jck.checkpoint_to_wire(got)]}) == data
    eng = _jax_engine()
    res = jck.build_resumed_request(got)
    assert eng.adopt_checkpoint_kv(res, got.kv)
    assert eng.submit(res)
    _drive(eng, j_drive_step)
    assert eng.cache.stats.resumes == 1
    base = _baseline(_jax_engine(), JRequest, JSampling(**GREEDY),
                     j_drive_step)
    assert res.full_output_ids == base.output_ids


# -- the scheduler ------------------------------------------------------------

HW = dict(device_kind="h100", num_chips=1, tflops_bf16=989.0, hbm_gib=80.0,
          hbm_gbps=3350.0, ici_gbps=900.0)


def _scheduler(pkg, n=2):
    sched_cls, hw_cls = ((JScheduler, JHardwareInfo) if pkg == "jax"
                         else (GlobalScheduler, HardwareInfo))
    from parallax_tpu.config import normalize_config as j_normalize

    cfg = (j_normalize if pkg == "jax" else normalize_config)(TINY_QWEN2)
    sched = sched_cls(cfg, min_nodes_bootstrapping=1,
                      heartbeat_timeout_s=30.0, routing="cache_aware")
    sched.start()
    for i in range(n):
        sched.enqueue_join(f"n{i}", hw_cls(**HW))
    assert wait_for(lambda: len(sched.manager.pipelines) >= n)
    for i in range(n):
        sched.enqueue_update(f"n{i}", is_ready=True)
    assert wait_for(lambda: all(sched.manager.get(f"n{i}").is_ready
                                for i in range(n)))
    return sched


@pytest.mark.parametrize("pkg", ["port", "jax"])
def test_migration_targets_prefer_warm_replica(pkg):
    """The same digests and descriptors pick the same targets in both
    packages: the warm replica, the cold one when the warm is excluded,
    nothing when every pipeline is."""
    sched = _scheduler(pkg)
    try:
        toks = list(range(8 * 4))
        chain = block_hash_chain(toks, 4)
        sched.enqueue_update("n1", cache_digests={
            "seq": 1, "block": 4, "full": chain})
        assert wait_for(lambda: len(sched.manager.get("n1").cache_index) > 0)
        desc = {"prompt_tokens": len(toks), "chains": {"4": chain},
                "lora_id": None}
        t = sched.choose_migration_targets([dict(desc, rid="m1")],
                                           exclude={"nX"})
        assert t["m1"]["path"] == ["n1"]
        assert t["m1"]["predicted_cached_tokens"] == 28
        assert t["m1"]["head_layers"] == [0, 4]
        t2 = sched.choose_migration_targets([dict(desc, rid="m2")],
                                            exclude={"n1"})
        assert t2["m2"]["path"] == ["n0"]
        assert sched.choose_migration_targets(
            [dict(desc, rid="m3")], exclude={"n0", "n1"}) == {}
        assert sched.cluster_status()["migrations"]["targets_chosen"] == 2
    finally:
        sched.stop()


@pytest.mark.parametrize("pkg", ["port", "jax"])
def test_where_is_follows_migrations(pkg):
    sched = _scheduler(pkg, n=1)
    try:
        assert sched.migrated_head("r1") is None
        sched.record_migration("r1", "n1")
        sched.record_migration("r1", "n0")
        assert sched.migrated_head("r1") == "n0"
        assert sched.migration_stats["recorded"] == 2
    finally:
        sched.stop()


def test_leave_flags_surviving_heads_for_drain():
    """A 2-stage pipeline's tail death flags the HEAD for drain and counts
    it; a dying head flags nobody. The decode pool (the KV handoff's
    targets) takes the mixed pipeline the survivor forms, and answers no
    target when the asking head is all there is."""
    from parallax_tpu_torch.scheduling.node import Node
    from parallax_tpu_torch.scheduling.node_management import (
        NodeManager,
        Pipeline,
    )

    cfg = normalize_config(TINY_QWEN2)
    sched = GlobalScheduler(cfg, min_nodes_bootstrapping=1)
    mgr = NodeManager(cfg.num_hidden_layers)
    head = Node(node_id="h", hardware=HardwareInfo(**HW), model=cfg)
    tail = Node(node_id="t", hardware=HardwareInfo(**HW), model=cfg)
    head.set_layers(0, 2)
    tail.set_layers(2, 4)
    for n in (head, tail):
        n.is_ready = True
        mgr.add(n)
    mgr.register_pipelines([Pipeline(nodes=[head, tail])])
    sched.manager = mgr
    sched._handle_leave("t")
    assert sched.drain_requested("h") == ["t"]
    assert sched.drain_requested("h") == []
    assert sched.migration_stats["drains"] == 1
    want = [{"rid": "r", "prompt_tokens": 8}]
    assert [p.role for p in sched.manager.pipelines] == ["mixed"]
    assert sched.choose_migration_targets(want, pool="decode")["r"][
        "path"] == ["h"]
    assert sched.choose_migration_targets(want, exclude={"h"},
                                          pool="decode") == {}
    assert sched.disagg_stats == {"target_queries": 2, "targets_chosen": 1,
                                  "no_target": 1}


# -- grammar checkpoints -------------------------------------------------------

G_SCHEMA = ('{"type": "object", "properties": {"v": {"enum": ["x", "y"]}}, '
            '"required": ["v"]}')
# Byte tokens over the 199-id model, EOS last.
G_VOCAB = [bytes([i]) for i in range(198)] + [b""]
G_EOS = 198


def _grammar_ckpt(dfa_state=3):
    ck = _mk_ckpt(with_kv=False)
    ck.sampling_params = SamplingParams(
        temperature=0.0, max_new_tokens=32, json_schema=G_SCHEMA).to_dict()
    ck.dfa_state = dfa_state
    ck.grammar_hash = grammar_state_hash(G_SCHEMA)
    return ck


class TestGrammarCheckpoint:
    def test_wire_roundtrip(self):
        ck = _grammar_ckpt()
        back = checkpoint_from_wire(
            wire.unpackb(wire.packb(checkpoint_to_wire(ck))))
        assert back.dfa_state == ck.dfa_state
        assert back.grammar_hash == ck.grammar_hash
        plain = checkpoint_to_wire(_mk_ckpt(with_kv=False))
        assert "dfa_state" not in plain and "grammar_hash" not in plain
        assert checkpoint_from_wire(plain).dfa_state is None

    @pytest.mark.parametrize("mutate,desc", [
        (lambda d: d.update(dfa_state="x"), "non-int state"),
        (lambda d: d.update(dfa_state=1 << 40), "state out of range"),
        (lambda d: d.update(grammar_hash=""), "state without hash"),
        (lambda d: d.update(grammar_hash="h" * 99), "oversized hash"),
        (lambda d: d.update(
            sampling_params=SamplingParams(max_new_tokens=8).to_dict()
        ), "dfa_state without json_schema"),
    ])
    def test_corrupt_grammar_frames_rejected(self, mutate, desc):
        d = checkpoint_to_wire(_grammar_ckpt())
        mutate(d)
        with pytest.raises(CheckpointError):
            checkpoint_from_wire(d)
        checkpoint_from_wire(checkpoint_to_wire(_grammar_ckpt()))

    def test_replay_does_not_preseed_state(self):
        adopt = build_resumed_request(_grammar_ckpt())
        assert getattr(adopt, "grammar_dfa_state", None) == 3
        rep = build_resumed_request(_grammar_ckpt(), replay=True)
        assert getattr(rep, "grammar_dfa_state", None) is None

    def test_initial_state_validates_hash(self):
        eng = _port_engine()
        eng.set_grammar_vocab(G_VOCAB, G_EOS)
        table = eng.grammar.compile(G_SCHEMA)

        def mk_req(**attrs):
            r = Request("gr", prompt_ids=[1, 2],
                        sampling_params=SamplingParams(
                            max_new_tokens=8, json_schema=G_SCHEMA))
            for k, v in attrs.items():
                setattr(r, k, v)
            return r

        good = mk_req(grammar_dfa_state=2,
                      grammar_hash=grammar_state_hash(G_SCHEMA))
        assert eng._grammar_initial_state(good, table) == 2
        stale = mk_req(grammar_dfa_state=2, grammar_hash="deadbeef")
        assert eng._grammar_initial_state(stale, table) == 0
        oob = mk_req(grammar_dfa_state=table.dfa.n_states + 7,
                     grammar_hash=grammar_state_hash(G_SCHEMA))
        assert eng._grammar_initial_state(oob, table) == 0

    _BASE: dict = {}

    @classmethod
    def _unchurned(cls, sp):
        """The constrained request served whole, once for both modes."""
        if "base" not in cls._BASE:
            eng = _port_engine(decode_lookahead=8)
            eng.set_grammar_vocab(G_VOCAB, G_EOS)
            base = Request("base", prompt_ids=[1, 2, 3],
                           sampling_params=dataclasses.replace(sp))
            eng.submit(base)
            _drive(eng)
            assert base.status.is_finished
            json.loads(bytes(t for t in base.output_ids if t < 198))
            cls._BASE["base"] = base
        return cls._BASE["base"]

    @pytest.mark.parametrize("mode", ["adopt", "replay"])
    def test_constrained_migration_bit_identical(self, mode):
        """A constrained request parked mid-decode, its DFA state read
        before extraction, restores (image adopted with the checkpointed
        state, or replayed from state 0) and finishes bit-identically to
        an unchurned run, schema-valid."""
        sp = SamplingParams(temperature=0.0, max_new_tokens=36,
                            json_schema=G_SCHEMA)
        base = self._unchurned(sp)

        eng_a = _port_engine(decode_lookahead=8)
        eng_a.set_grammar_vocab(G_VOCAB, G_EOS)
        mig = Request("mig", prompt_ids=[1, 2, 3],
                      sampling_params=dataclasses.replace(sp))
        eng_a.submit(mig)
        _drive_tokens(eng_a, mig, 3)
        assert not mig.status.is_finished
        grammar = eng_a.grammar_checkpoint_fields("mig")
        assert grammar is not None and grammar[0] > 0
        image = None
        if mode == "adopt":
            assert eng_a.cache.preempt_to_host(mig)
            image = eng_a.harvest_kv_image(mig)
        eng_a.extract("mig")
        assert eng_a.grammar_checkpoint_fields("mig") is None
        ckpt = checkpoint_from_request(mig, routing_table=["B"], kv=image,
                                       grammar=grammar)
        eng_a.cache.release(mig)
        got = checkpoint_from_wire(checkpoint_to_wire(ckpt))
        assert got.dfa_state == grammar[0]

        eng_b = _port_engine(decode_lookahead=8)
        eng_b.set_grammar_vocab(G_VOCAB, G_EOS)
        res = build_resumed_request(got, replay=mode == "replay")
        if mode == "adopt":
            assert eng_b.adopt_checkpoint_kv(res, got.kv)
        assert eng_b.submit(res)
        _drive(eng_b)
        assert res.status.is_finished
        assert res.full_output_ids == base.output_ids
        json.loads(bytes(t for t in res.full_output_ids if t < 198))

    def test_jax_worker_reads_grammar_after_extract(self):
        """The fault of the reference the port's worker avoids: the JAX
        worker asks ``grammar_checkpoint_fields`` on its ship thread,
        after ``_park_request`` extracted the request, and extraction drops
        the DFA state, so a JAX migration never carries ``dfa_state``. The
        port's ``_park_request`` reads it before ``extract``."""
        eng = _jax_engine()
        eng.set_grammar_vocab(G_VOCAB, G_EOS)
        req = JRequest("g", prompt_ids=[1, 2, 3], sampling_params=JSampling(
            temperature=0.0, max_new_tokens=36, json_schema=G_SCHEMA))
        eng.submit(req)
        _drive_tokens(eng, req, 3, j_drive_step)
        assert eng.grammar_checkpoint_fields("g") is not None
        eng.extract("g")
        assert eng.grammar_checkpoint_fields("g") is None


# -- the worker's RPCs ---------------------------------------------------------


@pytest.fixture
def worker():
    from tests.test_torch_swarm import CFG, _port_params

    reg = {}
    node = WorkerNode(LoopbackTransport("w", reg), None, CFG,
                      EngineConfig(page_size=8, num_pages=64,
                                   max_model_len=128, kv_dtype="float32"),
                      load_params=_port_params, layers=(0, 4), device="cpu")
    client = LoopbackTransport("c", reg)
    node.start()
    try:
        assert wait_for(lambda: node.engine is not None, 30.0)
        yield node, client
    finally:
        node.stop()


def _poll(client, rid, timeout=30.0):
    out = {}

    def done():
        out.update(client.call("w", proto.CHAT_POLL, {"rid": rid}))
        return out.get("finished")

    assert wait_for(done, timeout), out
    return out


def _submit(client, rid, prompt, **extra):
    client.call("w", proto.CHAT_SUBMIT, {
        "rid": rid, "prompt_ids": list(prompt), "routing_table": ["w"],
        "sampling_params": SamplingParams(
            temperature=0.0, max_new_tokens=12, ignore_eos=True).to_dict(),
        **extra,
    })


def test_chat_submit_replay_ids_teacher_forces(worker):
    """The client resume rung: a chat_submit carrying replay_ids
    teacher-forces exactly those tokens before free-running — the stream
    equals an uninterrupted serve, even when the replayed tokens are not
    the ones the model would sample."""
    node, client = worker
    _submit(client, "base", [1, 2, 3, 4, 5])
    stream = _poll(client, "base")["output_ids"]
    assert len(stream) == 12
    _submit(client, "replayed", [1, 2, 3, 4, 5], replay_ids=stream[:6])
    assert _poll(client, "replayed")["output_ids"] == stream
    forced = [7, 7, 7]
    _submit(client, "forced", [1, 2, 3, 4, 5], replay_ids=forced,
            replay_logprobs=[-1.0, -2.0, -3.0])
    out = _poll(client, "forced")
    assert out["output_ids"][:3] == forced and len(out["output_ids"]) == 12


def test_rpc_checkpoint_restores_and_rejects_corrupt_frames(worker):
    """``rpc_checkpoint`` accepts a valid frame (the restore continues the
    stream: replay here, the engine has no host tier), rejects a corrupt
    one by CheckpointError, acks a duplicate without a second submit, and
    a poll of the restored request answers."""
    node, client = worker
    _submit(client, "base", [9, 8, 7, 6])
    stream = _poll(client, "base")["output_ids"]
    req = Request("moved", prompt_ids=[9, 8, 7, 6],
                  sampling_params=SamplingParams(
                      temperature=0.0, max_new_tokens=12, ignore_eos=True))
    req.status = RequestStatus.DECODING
    for t in stream[:5]:
        req.commit_token(t)
    good = checkpoint_to_wire(checkpoint_from_request(req, ["w"]))
    bad = dict(good, rid="broken", v=99)
    reply = client.call("w", proto.CHECKPOINT,
                        {"checkpoints": [good, bad]})
    assert reply["accepted"] == ["moved"]
    assert "unsupported checkpoint version" in reply["rejected"]["broken"]
    again = client.call("w", proto.CHECKPOINT, {"checkpoints": [good]})
    assert again["accepted"] == ["moved"]
    assert _poll(client, "moved")["output_ids"] == stream
    assert node.restores["moved"][0] == "replay"
