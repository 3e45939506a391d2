"""Disaggregated prefill / decode in the port: roles, pools and the KV
transfer wire, on the CPU, against tests/test_disaggregation.py's cases and
the JAX package itself.

- Roles and pools: ``resolve_role``, a pipeline's role, the phase-filtered
  eligible pipelines (the prompt phase falls back, the decode phase does
  not), the role-aware allocator, a scheduler's joins with roles and its
  ``routing.pools`` / ``disagg`` status, and the decode-pool targets
  (never a prefill specialist; an empty answer when no decode pool
  exists) — each run in both packages with equal results.
- The wire: tests/test_disaggregation.py's seven ``TestKVTransferWire``
  cases on the port's ``image_to_frames`` / ``HandoffAssembler``; the
  port's frames, encoded by its own codec, equal the JAX frames under
  msgpack byte for byte for the same f32 and bf16 images; each package's
  assembler accepts the other's frames.
- The RPC surface: ``join --role`` and ``--kv-transfer-chunk-bytes``
  reach the worker; ``node_join`` takes a role; ``disagg_target``,
  ``rpc_kv_transfer`` and ``kv_handoff_result`` are served; a scheduler
  reply that re-roles the worker (the QoS autoscaler's) is adopted in
  place; a scheduler-less worker ignores a role.
- The handoff checkpoint: the JAX helper ships no DFA state for a
  constrained row; the port's ships the state its park read.
"""

import json
import os
import time
import types

import ml_dtypes
import numpy as np
import pytest
import torch

import parallax_tpu.scheduling.layer_allocation as j_alloc
import parallax_tpu.scheduling.node as j_node
import parallax_tpu.scheduling.node_management as j_mgmt
import parallax_tpu.scheduling.request_routing as j_routing
import parallax_tpu.scheduling.scheduler as j_sched
from parallax_tpu.config import normalize_config as j_normalize
from parallax_tpu.p2p import proto as jproto
from parallax_tpu.runtime import checkpoint as jck
from parallax_tpu.runtime import kv_handoff as jkvh
from parallax_tpu.runtime.request import SamplingParams as JSampling
from parallax_tpu.utils.hw import HardwareInfo as JHardwareInfo
from parallax_tpu_torch import cli
from parallax_tpu_torch.backend.scheduler_service import SchedulerService
from parallax_tpu_torch.config import normalize_config, resolve_role
from parallax_tpu_torch.p2p import proto
from parallax_tpu_torch.p2p.join import build_worker
from parallax_tpu_torch.p2p.node import WorkerNode
from parallax_tpu_torch.p2p.transport import LoopbackTransport
from parallax_tpu_torch.runtime.checkpoint import (
    KVImage,
    RequestCheckpoint,
    checkpoint_to_wire,
)
from parallax_tpu_torch.runtime.engine import EngineConfig
from parallax_tpu_torch.runtime.kv_handoff import (
    HandoffAssembler,
    HandoffStats,
    image_to_frames,
)
from parallax_tpu_torch.runtime.request import SamplingParams
from parallax_tpu_torch.scheduling import layer_allocation as p_alloc
from parallax_tpu_torch.scheduling import node as p_node
from parallax_tpu_torch.scheduling import node_management as p_mgmt
from parallax_tpu_torch.scheduling import request_routing as p_routing
from parallax_tpu_torch.scheduling import scheduler as p_sched
from parallax_tpu_torch.utils.hw import HardwareInfo

TINY_RAW = dict(
    architectures=["Qwen2ForCausalLM"],
    hidden_size=64, num_hidden_layers=4, num_attention_heads=4,
    num_key_value_heads=2, intermediate_size=128, vocab_size=151,
    max_position_embeddings=256,
)
HW = ("v5e", 1, 197.0, 16.0, 819.0, 186.0)
PKGS = {
    "jax": types.SimpleNamespace(
        cfg=j_normalize(TINY_RAW), HW=JHardwareInfo, node=j_node,
        mgmt=j_mgmt, alloc=j_alloc, routing=j_routing, sched=j_sched),
    "port": types.SimpleNamespace(
        cfg=normalize_config(TINY_RAW), HW=HardwareInfo, node=p_node,
        mgmt=p_mgmt, alloc=p_alloc, routing=p_routing, sched=p_sched),
}
ENGINE = dict(page_size=8, num_pages=32, max_model_len=64,
              kv_dtype="float32", max_num_tokens_per_batch=64,
              max_batch_size=4)


def both(fn):
    """``fn(pkg)`` in each package; the results must be equal."""
    got = {name: fn(pkg) for name, pkg in PKGS.items()}
    assert got["jax"] == got["port"], got
    return got["port"]


def wait_for(cond, timeout=10.0):
    end = time.monotonic() + timeout
    while time.monotonic() < end:
        if cond():
            return True
        time.sleep(0.01)
    return False


# -- roles + pools -----------------------------------------------------------


def test_resolve_role():
    assert resolve_role(None) == "mixed"
    assert resolve_role("") == "mixed"
    assert resolve_role("Prefill") == "prefill"
    with pytest.raises(ValueError):
        resolve_role("both")


def _node(pkg, nid, role="mixed", ready=True, layers=(0, 4)):
    n = pkg.node.Node(node_id=nid, hardware=pkg.HW(*HW), model=pkg.cfg,
                      role=role)
    n.set_layers(*layers)
    n.is_ready = ready
    return n


def _manager(pkg, *pipes):
    """A NodeManager with hand-registered pipelines: each arg is a list of
    (nid, role) stages."""
    mgr = pkg.mgmt.NodeManager(pkg.cfg.num_hidden_layers)
    for stages in pipes:
        nodes = []
        per = pkg.cfg.num_hidden_layers // len(stages)
        for i, (nid, role) in enumerate(stages):
            n = _node(pkg, nid, role=role, layers=(i * per, (i + 1) * per))
            mgr.add(n)
            nodes.append(n)
        mgr.register_pipelines([pkg.mgmt.Pipeline(nodes=nodes)])
    return mgr


def test_pipeline_role_derivation():
    roles = both(lambda pkg: [p.role for p in _manager(
        pkg, [("p0", "prefill"), ("p1", "prefill")], [("d0", "decode")],
        [("x0", "prefill"), ("x1", "decode")]).pipelines])
    assert roles == ["prefill", "decode", "mixed"]


def test_phase_filtered_eligibility_and_prompt_fallback():
    def run(pkg):
        eligible = pkg.routing.eligible_pipelines

        def ids(ps):
            return sorted(p.nodes[0].node_id for p in ps)

        mgr = _manager(pkg, [("p0", "prefill")], [("d0", "decode")],
                       [("m0", "mixed")])
        mgr2 = _manager(pkg, [("d0", "decode")])
        mgr3 = _manager(pkg, [("p0", "prefill")])
        return [ids(eligible(mgr)), ids(eligible(mgr, phase="prompt")),
                ids(eligible(mgr, phase="decode")),
                # The prompt phase falls back to everything eligible when
                # its pool is gone; the decode phase does not.
                ids(eligible(mgr2, phase="prompt")),
                ids(eligible(mgr2, phase="decode")),
                ids(eligible(mgr3, phase="prompt")),
                ids(eligible(mgr3, phase="decode"))]

    assert both(run) == [["d0", "m0", "p0"], ["m0", "p0"], ["d0", "m0"],
                         ["d0"], ["d0"], ["p0"], []]


def test_role_aware_allocation_keeps_pools_separate():
    def run(pkg):
        nodes = [_node(pkg, "p0", "prefill"), _node(pkg, "d0", "decode"),
                 _node(pkg, "m0", "mixed")]
        for n in nodes:
            n.clear_layers()
        pipes = pkg.alloc.GreedyLayerAllocator(
            pkg.cfg.num_hidden_layers).allocate_role_aware(nodes)
        return [(p.role, sorted({n.role for n in p.nodes}),
                 [n.node_id for n in p.nodes]) for p in pipes]

    # Mixed nodes allocate first, then prefill, then decode.
    assert both(run) == [("mixed", ["mixed"], ["m0"]),
                         ("prefill", ["prefill"], ["p0"]),
                         ("decode", ["decode"], ["d0"])]


def _joined_pair(pkg):
    sched = pkg.sched.GlobalScheduler(pkg.cfg, min_nodes_bootstrapping=2)
    sched.start()
    sched.enqueue_join("p0", pkg.HW(*HW), role="prefill")
    sched.enqueue_join("d0", pkg.HW(*HW), role="decode")
    assert wait_for(lambda: len(sched.manager.pipelines) >= 2)
    for nid in ("p0", "d0"):
        sched.enqueue_update(nid, is_ready=True)
    assert wait_for(lambda: all(sched.manager.get(n).is_ready
                                for n in ("p0", "d0")))
    return sched


def test_scheduler_join_role_and_status_pools():
    def run(pkg):
        sched = _joined_pair(pkg)
        try:
            st = sched.cluster_status()
            pools = st["routing"]["pools"]
            return {
                "roles": sorted(p["role"] for p in st["pipelines"]),
                "node_roles": sorted(n["role"] for p in st["pipelines"]
                                     for n in p["nodes"]),
                "alloc_role": sched.get_node_allocation("p0")["role"],
                "pools": {r: (d["pipelines"], d["in_flight"],
                              d["capacity"] > 0, d["utilization"])
                          for r, d in pools.items()},
                "disagg": st["disagg"],
                "queued_unrouted": st["routing"]["queued_unrouted"],
            }
        finally:
            sched.stop()

    got = both(run)
    assert got["roles"] == ["decode", "prefill"]
    assert got["alloc_role"] == "prefill"
    assert got["pools"] == {"prefill": (1, 0, True, 0.0),
                            "decode": (1, 0, True, 0.0)}
    assert got["disagg"] == {"active": True, "target_queries": 0,
                             "targets_chosen": 0, "no_target": 0}


def test_decode_pool_targets_exclude_prefill():
    def run(pkg):
        sched = _joined_pair(pkg)
        try:
            t = sched.choose_migration_targets(
                [{"rid": "r1", "prompt_tokens": 16, "lora_id": None}],
                exclude={"p0"}, pool="decode")
            chosen = dict(sched.disagg_stats)
            # A prefill-only swarm has NO decode targets: the head keeps
            # the request local instead of bouncing it to a prompt pool.
            t2 = sched.choose_migration_targets(
                [{"rid": "r2", "prompt_tokens": 16, "lora_id": None}],
                exclude={"d0"}, pool="decode")
            return (t["r1"]["path"], t2, chosen, dict(sched.disagg_stats),
                    sched.migration_stats["targets_chosen"])
        finally:
            sched.stop()

    path, empty, chosen, after, migrations = both(run)
    assert path == ["d0"] and empty == {}
    assert chosen == {"target_queries": 1, "targets_chosen": 1,
                      "no_target": 0}
    assert after == {"target_queries": 2, "targets_chosen": 1,
                     "no_target": 1}
    assert migrations == 0


# -- the KV-transfer wire ----------------------------------------------------


def _np_layers(n_layers=4, n_pages=3, page=4, dtype=np.float32):
    rng = np.random.default_rng(7)
    return [rng.standard_normal((n_pages, 2, page, 2, 8),
                                dtype=np.float32).astype(dtype)
            for _ in range(n_layers)]


def _image(n_layers=4, n_pages=3, page=4, pkg="port", dtype="float32"):
    """tests/test_disaggregation.py's image; ``dtype`` float32 or
    bfloat16 (the same bits in both packages)."""
    npd = np.float32 if dtype == "float32" else ml_dtypes.bfloat16
    arrs = _np_layers(n_layers, n_pages, page, npd)
    cls = jck.KVImage if pkg == "jax" else KVImage
    if pkg == "port":
        arrs = [torch.from_numpy(a) if dtype == "float32"
                else torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
                for a in arrs]
    return cls(page_size=page, start_layer=0, end_layer=n_layers,
               kv_dtype=dtype, prefix_tokens=0,
               computed_tokens=n_pages * page, layers=arrs)


def _ckpt_wire(rid="h-1", pkg="port"):
    ck_cls, to_wire, sp_cls = (
        (jck.RequestCheckpoint, jck.checkpoint_to_wire, JSampling)
        if pkg == "jax" else
        (RequestCheckpoint, checkpoint_to_wire, SamplingParams))
    return to_wire(ck_cls(
        request_id=rid, prompt_ids=list(range(5, 17)),
        output_ids=[20, 21], output_logprobs=[-0.5, -0.25],
        sampling_params=sp_cls(temperature=0.0,
                               max_new_tokens=16).to_dict(),
        eos_token_ids=[0], lora_id=None, routing_table=["d0"],
        age_s=0.5, parked_wall=1.0, handoff=True,
    ))


class TestKVTransferWire:
    def test_frames_roundtrip_bitwise(self):
        image = _image()
        frames = image_to_frames("h-1", _ckpt_wire(), image,
                                 chunk_bytes=1)   # one layer per frame
        kinds = [f["kind"] for f, _b in frames]
        assert kinds[0] == "begin" and kinds[-1] == "end"
        assert kinds.count("layers") == len(image.layers)
        stats = HandoffStats()
        asm = HandoffAssembler(stats=stats)
        done = None
        for f, _b in frames:
            res = asm.feed("p0", f)
            if res is not None:
                assert res[0] == "done", res
                done = res[1]
        assert done is not None and asm.partial_count() == 0
        assert done.handoff is True
        assert done.kv is not None
        assert done.kv.computed_tokens == image.computed_tokens
        for a, b in zip(done.kv.layers, image.layers):
            assert a.dtype == b.dtype and torch.equal(a, b)
        nbytes = sum(t.numel() * t.element_size() for t in image.layers)
        assert stats.transfer_bytes["in"] == nbytes
        assert stats.transfer_frames["in"] == len(frames)
        assert len(stats.transfer_s) == 1

    def test_chunking_groups_layers(self):
        image = _image(n_layers=4)
        per_layer = image.layers[0].numel() * image.layers[0].element_size()
        frames = image_to_frames("h-1", _ckpt_wire(), image,
                                 chunk_bytes=2 * per_layer)
        layer_frames = [f for f, _b in frames if f["kind"] == "layers"]
        assert len(layer_frames) == 2
        assert [f["idx"] for f in layer_frames] == [0, 2]
        assert [b for f, b in frames if f["kind"] == "layers"] == [
            2 * per_layer, 2 * per_layer]

    def test_truncated_transfer_rejected(self):
        frames = image_to_frames("h-1", _ckpt_wire(), _image(),
                                 chunk_bytes=1)
        asm = HandoffAssembler()
        # Drop one layer frame: the gap rejects the transfer (the first
        # out-of-order frame kills it; later frames then find no transfer
        # in progress — also an error, never a silent accept).
        errors = []
        for f, _b in frames[:2] + frames[3:]:
            res = asm.feed("p0", f)
            if res is not None:
                assert res[0] == "error", res
                errors.append(res[1])
        assert any("out of sequence" in e or "truncated" in e
                   for e in errors), errors
        assert asm.partial_count() == 0

    def test_corrupt_tensor_rejected_by_checkpoint_decoder(self):
        frames = image_to_frames("h-1", _ckpt_wire(), _image(),
                                 chunk_bytes=1)
        # Truncate one tensor's bytes: shape / byte disagreement.
        frames[2][0]["layers"][0]["data"] = (
            frames[2][0]["layers"][0]["data"][:-8])
        asm = HandoffAssembler()
        res = None
        for f, _b in frames:
            res = asm.feed("p0", f)
        assert res is not None and res[0] == "error"

    def test_unknown_rid_and_unknown_kind(self):
        asm = HandoffAssembler()
        res = asm.feed("p0", {"rid": "x", "kind": "layers", "idx": 0,
                              "layers": []})
        assert res == ("error", "no transfer in progress for x")
        asm.feed("p0", {"rid": "x", "kind": "begin", "ckpt": {},
                        "header": {}})
        res = asm.feed("p0", {"rid": "x", "kind": "bogus"})
        assert res is not None and res[0] == "error"

    def test_interleaved_transfers(self):
        asm = HandoffAssembler()
        img = _image(n_layers=2)
        fa = image_to_frames("a", _ckpt_wire("a"), img, chunk_bytes=1)
        fb = image_to_frames("b", _ckpt_wire("b"), img, chunk_bytes=1)
        done = {}
        for f, _b in [x for pair in zip(fa, fb) for x in pair]:
            res = asm.feed("p0", f)
            if res is not None:
                assert res[0] == "done"
                done[res[1].request_id] = res[1]
        assert set(done) == {"a", "b"}

    def test_sweep_discards_orphans(self):
        stats = HandoffStats()
        asm = HandoffAssembler(timeout_s=0.0, stats=stats)
        asm.feed("p0", {"rid": "x", "kind": "begin", "ckpt": {},
                        "header": {}})
        assert asm.partial_count() == 1
        assert asm.sweep() == [("x", "p0")]
        assert asm.partial_count() == 0
        assert stats.fallbacks == {"transfer_abandoned": 1}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("chunk", [1, 2 * 3 * 2 * 4 * 2 * 8 * 4, 1 << 22],
                         ids=["layer-a-frame", "two-layers", "one-frame"])
def test_frames_byte_identical_to_jax(dtype, chunk):
    """The same checkpoint and image framed by each package: every frame
    the port's codec encodes equals the JAX package's msgpack encoding,
    byte for byte, with the same payload counts."""
    port = image_to_frames("h-1", _ckpt_wire(), _image(dtype=dtype), chunk)
    jax_ = jkvh.image_to_frames("h-1", _ckpt_wire(pkg="jax"),
                                _image(pkg="jax", dtype=dtype), chunk)
    assert [b for _f, b in port] == [b for _f, b in jax_]
    for i, ((pf, _pb), (jf, _jb)) in enumerate(zip(port, jax_)):
        assert proto.encode_frame(proto.KV_TRANSFER, pf, msg_id=i) == \
            jproto.encode_frame(jproto.KV_TRANSFER, jf, msg_id=i), i
    assert len(port) == len(jax_)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_assemblers_accept_each_others_frames(dtype):
    """Frames across the wire both ways: the JAX assembler completes the
    port's frames (decoded by msgpack) and the port's assembler the JAX
    frames (decoded by the port's codec), each into the same checkpoint
    with the image's bits."""
    ref = [a.view(np.uint16) if dtype == "bfloat16" else a
           for a in _np_layers(dtype=np.float32 if dtype == "float32"
                               else ml_dtypes.bfloat16)]
    port_frames = image_to_frames("h-1", _ckpt_wire(), _image(dtype=dtype),
                                  chunk_bytes=1)
    jax_frames = jkvh.image_to_frames(
        "h-1", _ckpt_wire(pkg="jax"), _image(pkg="jax", dtype=dtype),
        chunk_bytes=1)
    jasm, pasm = jkvh.HandoffAssembler(), HandoffAssembler()
    jdone = pdone = None
    for f, _b in port_frames:
        res = jasm.feed("p0", jproto.decode_frame(
            proto.encode_frame(proto.KV_TRANSFER, f))["p"])
        if res is not None:
            assert res[0] == "done", res
            jdone = res[1]
    for f, _b in jax_frames:
        res = pasm.feed("p0", proto.decode_frame(
            jproto.encode_frame(jproto.KV_TRANSFER, f))["p"])
        if res is not None:
            assert res[0] == "done", res
            pdone = res[1]
    assert jdone.handoff and pdone.handoff
    assert jdone.request_id == pdone.request_id == "h-1"
    assert jdone.output_ids == pdone.output_ids == [20, 21]
    for want, j, p in zip(ref, jdone.kv.layers, pdone.kv.layers):
        j = np.asarray(j)
        p = (p.view(torch.int16).numpy().view(np.uint16)
             if dtype == "bfloat16" else p.numpy())
        if dtype == "bfloat16":
            j = j.view(np.uint16)
        assert np.array_equal(j, want) and np.array_equal(p, want)


# -- the RPC surface -----------------------------------------------------------


def test_join_role_and_chunk_flags_reach_the_worker(tmp_path):
    """``join --role`` and ``--kv-transfer-chunk-bytes`` pass the CLI and
    reach the worker; without them it is mixed with 4 MiB frames."""
    with open(os.path.join(tmp_path, "config.json"), "w") as f:
        json.dump(TINY_RAW, f)
    base = ["join", "--model-path", str(tmp_path), "--device", "cpu",
            "--port", "0", "--advertise-addr", "127.0.0.1",
            "--scheduler-addr", "127.0.0.1:1"]
    got = []
    for extra in (["--role", "prefill", "--kv-transfer-chunk-bytes",
                   "1024"], ["--role", "decode"], []):
        args = cli.build_parser().parse_args(base + extra)
        assert cli.unported_flags(args) == []
        node = build_worker(args)
        node.transport.stop()
        got.append((node.role, node.kv_transfer_chunk_bytes))
    assert got == [("prefill", 1024), ("decode", 4 << 20),
                   ("mixed", 4 << 20)]


def test_scheduler_less_worker_ignores_a_role():
    node = WorkerNode(LoopbackTransport("w", {}), None,
                      normalize_config(TINY_RAW), EngineConfig(**ENGINE),
                      layers=(0, 4), device="cpu", role="prefill")
    assert node.role == "mixed"


@pytest.mark.parametrize("role", ["prefill", "decode", "mixed"])
def test_node_join_carries_the_role(role):
    """A ``node_join`` with a role is served: the scheduler records it and
    the allocation echoes it; the worker accepts its own role back."""
    cfg = normalize_config(TINY_RAW)
    reg = {}
    sched = p_sched.GlobalScheduler(cfg, min_nodes_bootstrapping=1)
    svc = SchedulerService(sched, LoopbackTransport("sched", reg),
                           join_timeout_s=10.0)
    svc.start()
    try:
        reply = LoopbackTransport("w0", reg).call("sched", proto.NODE_JOIN, {
            "node_id": "w0", "hardware": HardwareInfo(*HW).to_dict(),
            "wire_formats": list(proto.WIRE_DTYPES), "role": role})
        assert reply["role"] == role and reply["start_layer"] == 0
        assert sched.manager.get("w0").role == role
        # The worker accepts the reply whole: its refit fields (version 0,
        # no index) ask for nothing.
        node = WorkerNode(LoopbackTransport("w1", {}), "sched", cfg,
                          EngineConfig(**ENGINE), device="cpu", role=role)
        node._adopt_refit_reply(reply)
        assert reply.get("refit_version", 0) == 0 and node._inbox.empty()
    finally:
        svc.stop()


def test_a_re_role_is_refused_as_item_9():
    """Item 9 is ported: a scheduled worker adopts a re-role in place (host
    state only, no reload) and records a ``qos_rerole`` flight event; a
    scheduler-less worker keeps its mixed role. Item 12 is ported too: a
    reply's newer refit version goes to the step thread, an empty index or
    a version already served posts nothing."""
    from parallax_tpu_torch.obs.flight import get_flight

    cfg = normalize_config(TINY_RAW)
    for own, other in (("mixed", "prefill"), ("prefill", "decode")):
        node = WorkerNode(LoopbackTransport("w", {}), "sched", cfg,
                          EngineConfig(**ENGINE), device="cpu", role=own)
        node._adopt_refit_reply({"role": other})
        node._adopt_qos_reply({"role": other, "qos_shed": True})
        assert node.role == other and node.engine is None
        ev = [e for e in get_flight().events_since(0, limit=4096)[0]
              if e.get("kind") == "qos_rerole" and e.get("prev") == own]
        assert ev and ev[-1]["role"] == other
    alone = WorkerNode(LoopbackTransport("w", {}), None, cfg,
                       EngineConfig(**ENGINE), layers=(0, 4), device="cpu")
    alone._adopt_qos_reply({"role": "prefill"})
    assert alone.role == "mixed"
    alone._adopt_refit_reply({"role": None, "refit_index": None})
    assert alone._inbox.empty()
    alone._adopt_refit_reply({"refit_index": {"a": "b"}, "refit_version": 1})
    assert alone._inbox.get_nowait() == ("refit", 1, {"a": "b"})
    alone.refit_version = 1
    alone._adopt_refit_reply({"refit_index": {"a": "b"}, "refit_version": 1})
    assert alone._inbox.empty()


def test_disagg_target_rpc_is_served():
    """``disagg_target`` answers decode-pool paths over the RPC, excludes
    the asking head, and answers an empty map for a malformed query."""
    cfg = normalize_config(TINY_RAW)
    reg = {}
    sched = p_sched.GlobalScheduler(cfg, min_nodes_bootstrapping=2)
    svc = SchedulerService(sched, LoopbackTransport("sched", reg),
                           join_timeout_s=10.0)
    svc.start()
    try:
        for nid, role in (("p0", "prefill"), ("d0", "decode")):
            sched.enqueue_join(nid, HardwareInfo(*HW), role=role)
        assert wait_for(lambda: len(sched.manager.pipelines) == 2)
        for nid in ("p0", "d0"):
            sched.enqueue_update(nid, is_ready=True)
        assert wait_for(lambda: all(sched.manager.get(n).is_ready
                                    for n in ("p0", "d0")))
        client = LoopbackTransport("p0x", reg)
        reply = client.call("sched", proto.DISAGG_TARGET, {
            "requests": [{"rid": "r", "prompt_tokens": 8,
                          "lora_id": None}], "exclude": ["p0"]})
        assert reply["targets"]["r"]["path"] == ["d0"]
        assert reply["targets"]["r"]["head_layers"] == [0, 4]
        assert client.call("sched", proto.DISAGG_TARGET,
                           {"requests": "x"}) == {"targets": {}}
        assert sched.disagg_stats["targets_chosen"] == 1
    finally:
        svc.stop()


def test_kv_transfer_and_result_are_served():
    """A worker serves ``rpc_kv_transfer``: a corrupt transfer is nacked
    back to its source by ``kv_handoff_result``, and an unknown result is
    taken (posted to the step loop, which drops it)."""
    cfg = normalize_config(TINY_RAW)
    reg = {}
    node = WorkerNode(LoopbackTransport("w", reg), "sched", cfg,
                      EngineConfig(**ENGINE), device="cpu", role="decode")
    results = []
    src = LoopbackTransport("src", reg)
    src.register(proto.KV_RESULT, lambda peer, p: results.append(p) or "ok")
    try:
        frames = image_to_frames("h-1", _ckpt_wire(), _image(),
                                 chunk_bytes=1)
        frames[2][0]["layers"][0]["data"] = b""
        for f, _b in frames:
            assert src.call("w", proto.KV_TRANSFER, f) == "ok"
        assert wait_for(lambda: results)
        assert results[0]["rid"] == "h-1" and results[0]["ok"] is False
        assert src.call("w", proto.KV_RESULT, {"rid": "zz", "ok": True}) \
            == "ok"
        assert node._inbox.get_nowait() == (
            "handoff_result", {"rid": "zz", "ok": True})
    finally:
        node.sender.close()
        node.kv_sender.close()


def test_handoff_checkpoint_grammar_fields_against_jax():
    """The JAX helper builds a handoff checkpoint from the request alone,
    so a constrained row's handoff carries no DFA state (its decode head
    recomputes it from the stream); the port's carries the
    (dfa_state, grammar_hash) its park read before ``extract``, through
    the wire and its strict decoder."""
    from parallax_tpu.runtime.request import Request as JRequest
    from parallax_tpu_torch.constrained import grammar_state_hash
    from parallax_tpu_torch.runtime.checkpoint import checkpoint_from_wire
    from parallax_tpu_torch.runtime.kv_handoff import handoff_checkpoint
    from parallax_tpu_torch.runtime.request import Request

    schema = '{"type": "object", "properties": {"v": {"enum": ["x"]}}}'
    sp = dict(temperature=0.0, max_new_tokens=8, json_schema=schema)
    jreq = JRequest("g", prompt_ids=[1, 2, 3],
                    sampling_params=JSampling(**sp))
    preq = Request("g", prompt_ids=[1, 2, 3],
                   sampling_params=SamplingParams(**sp))
    for r in (jreq, preq):
        r.commit_token(123)
    jck_ = jkvh.handoff_checkpoint(jreq, ["d0"], kv=None)
    assert jck_.handoff and jck_.dfa_state is None
    grammar = (5, grammar_state_hash(schema))
    pck = handoff_checkpoint(preq, ["d0"], kv=None, grammar=grammar)
    got = checkpoint_from_wire(checkpoint_to_wire(pck))
    assert got.handoff and (got.dfa_state, got.grammar_hash) == grammar
    assert got.output_ids == jck_.output_ids == [123]
