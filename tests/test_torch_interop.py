"""The port's reference protobuf wire (``parallax_tpu_torch/p2p/protowire.py``
and ``p2p/interop.py``) against the JAX package's, on the CPU.

- The port's proto3 codec writes the bytes ``interop_pb2``'s
  ``SerializeToString`` writes, and each reads the other's, on hypothesis
  messages: negative int32, an absent ``token_prob`` against 0.0, empty
  repeated fields, unknown fields skipped.
- The port's safetensors bytes equal ``safetensors.torch.save``'s and load
  there; the port loads the library's bytes (f32, bf16, f16), bf16 bitwise.
- The eleven cases of tests/test_interop.py that pass on the JAX package,
  on the port (the pipeline case through the port's engines).
- The port's ``ireqs_to_forward_bytes`` gives the JAX module's bytes for
  the same packets, and each decodes the other's.
- A real port ``WorkerNode`` (not ``__new__``) takes protobuf FORWARD and
  ABORT payloads over TCP, counts them in its inbound stats, errors a
  malformed payload and keeps serving: what the JAX baseline pair of
  tests/test_interop.py cannot reach.
"""

import shutil
import struct

import numpy as np
import pytest
import torch

if shutil.which("protoc") is None:
    pytest.skip("protoc not installed (the JAX reference's bindings)",
                allow_module_level=True)

import tests._torch_cpu  # noqa: F401  (one intra-op thread)

from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st
from safetensors.torch import load as st_load
from safetensors.torch import save as st_save

from parallax_tpu.p2p import interop as jinterop
from parallax_tpu.p2p.interop import pb
from parallax_tpu.runtime.request import IntermediateRequest as JIReq
from parallax_tpu_torch.models import create_stage_model
from parallax_tpu_torch.p2p import interop, proto, protowire
from parallax_tpu_torch.p2p.node import WorkerNode
from parallax_tpu_torch.p2p.transport import TcpTransport, TransportError
from parallax_tpu_torch.runtime.engine import EngineConfig, StageEngine
from parallax_tpu_torch.runtime.pipeline import InProcessPipeline
from parallax_tpu_torch.runtime.request import (
    IntermediateRequest,
    Request,
    SamplingParams,
)
from tests.test_torch_swarm import CFG, ENGINE, _port_params, _wait

# -- the proto3 codec against protobuf ----------------------------------------

INT32 = st.integers(-(1 << 31), (1 << 31) - 1)
F32 = st.floats(width=32, allow_nan=False)
TEXT = st.text(max_size=12)

SAMPLING = st.fixed_dictionaries({}, optional={
    "max_new_tokens": INT32, "min_new_tokens": INT32, "temperature": F32,
    "top_p": F32, "min_p": F32, "top_k": INT32,
    "stop_token_ids": st.lists(INT32, max_size=4), "ignore_eos": st.booleans(),
    "stop_strs": st.lists(TEXT, max_size=3), "repetition_penalty": F32,
    "presence_penalty": F32, "frequency_penalty": F32, "json_schema": TEXT,
})
REQ = st.fixed_dictionaries({}, optional={
    "rid": TEXT, "output_length": INT32,
    "routing_table": st.lists(TEXT, max_size=3),
    "input_ids": st.lists(INT32, max_size=6),
    "sampling_params": st.none() | SAMPLING,
    "next_token_id": INT32, "hidden_states": st.binary(max_size=24),
    "lora_path": TEXT,
    "token_prob": st.none() | st.just(0.0) | st.just(-0.0) | F32,
    "return_probs": st.booleans(),
})
FORWARD = st.fixed_dictionaries({}, optional={
    "forward_mode": st.sampled_from([0, 1, 2]),
    "reqs": st.lists(REQ, max_size=3)})


def _to_pb(msg, d: dict):
    """Set ``d``'s fields on the generated message ``msg`` (None: unset)."""
    for k, v in d.items():
        if v is None:
            continue
        field = getattr(msg, k)
        if k == "sampling_params":
            field.SetInParent()
            _to_pb(field, v)
        elif k == "reqs":
            for r in v:
                _to_pb(field.add(), r)
        elif isinstance(v, list):
            field.extend(v)
        else:
            setattr(msg, k, v)
    return msg


def _f32(x: float) -> float:
    return struct.unpack("<f", struct.pack("<f", x))[0]


def _same(message: str, got: dict, want: dict) -> None:
    """``got`` (decoded, every field filled) holds ``want``'s values."""
    for f in protowire.SCHEMA[message]:
        v = want.get(f.name)
        if v is None:
            v = protowire._default(f)
        if f.kind == "float" and v is not None:
            assert struct.pack("<f", got[f.name]) == struct.pack("<f", v)
        elif f.kind in protowire.SCHEMA:
            if f.repeated:
                assert len(got[f.name]) == len(v)
                for g, w in zip(got[f.name], v):
                    _same(f.kind, g, w)
            elif v is None:
                assert got[f.name] is None
            else:
                _same(f.kind, got[f.name], v)
        else:
            assert got[f.name] == v, f.name


@settings(max_examples=150, deadline=None,
          suppress_health_check=[HealthCheck.too_slow])
@given(FORWARD)
def test_protowire_equals_protobuf_both_ways(msg):
    ours = protowire.encode("ForwardRequest", msg)
    theirs = _to_pb(pb.ForwardRequest(), msg).SerializeToString()
    assert ours == theirs
    _same("ForwardRequest", protowire.decode("ForwardRequest", theirs), msg)
    parsed = pb.ForwardRequest.FromString(ours)
    assert parsed.SerializeToString() == ours
    for r, want in zip(parsed.reqs, msg.get("reqs", [])):
        tp = want.get("token_prob")
        assert r.HasField("token_prob") == (tp is not None)
        assert r.HasField("sampling_params") == (
            want.get("sampling_params") is not None)


@settings(max_examples=60, deadline=None)
@given(st.lists(TEXT, max_size=5))
def test_abort_request_both_ways(rids):
    want = _to_pb(pb.AbortRequest(),
                  {"reqs": [{"rid": r} for r in rids]}).SerializeToString()
    assert interop.rids_to_abort_bytes(rids) == want
    assert interop.abort_bytes_to_rids(want) == rids


def test_protowire_edge_cases():
    # A negative int32 is the 10-byte varint of its two's complement.
    neg = protowire.encode("Req", {"output_length": -1})
    assert neg == b"\x10" + b"\xff" * 9 + b"\x01"
    assert neg == _to_pb(pb.Req(), {"output_length": -1}).SerializeToString()
    # token_prob: absent writes nothing, 0.0 writes the field.
    assert protowire.encode("Req", {"token_prob": None}) == b""
    assert protowire.encode("Req", {"token_prob": 0.0}) == \
        _to_pb(pb.Req(), {"token_prob": 0.0}).SerializeToString() != b""
    assert protowire.decode("Req", b"")["token_prob"] is None
    assert protowire.decode(
        "Req", protowire.encode("Req", {"token_prob": 0.0}))[
            "token_prob"] == 0.0
    # Empty repeated fields and defaults write nothing; an empty message
    # field is present.
    assert protowire.encode("Req", {"input_ids": [], "routing_table": [],
                                    "rid": "", "return_probs": False}) == b""
    assert protowire.encode("Req", {"sampling_params": {}}) == b"\x2a\x00"
    # Unknown fields of every wire type are skipped; unpacked repeated
    # int32 is read too.
    unknown = (b"\xa8\x06\x05" + b"\xb1\x06" + b"\x00" * 8 + b"\xba\x06\x02ab"
               + b"\xc5\x06" + b"\x00" * 4)
    body = unknown + b"\x0a\x01x" + b"\x20\x07\x20\x09"
    got = protowire.decode("Req", body)
    assert got["rid"] == "x" and got["input_ids"] == [7, 9]
    assert got["input_ids"] == list(pb.Req.FromString(body).input_ids)
    with pytest.raises(protowire.DecodeError):
        protowire.decode("Req", b"\x0a\x05ab")
    with pytest.raises(ValueError):
        protowire.encode("Req", {"output_length": 1 << 31})


# -- safetensors ---------------------------------------------------------------


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("shape", [(3, 8), (1, 5), (7,), (0, 4)])
def test_safetensors_bytes_round_trip_with_the_library(dtype, shape):
    g = torch.Generator().manual_seed(0)
    t = (torch.randn(shape, generator=g) * 3).to(dtype)
    ours = interop.tensor_to_safetensors(t)
    assert ours == st_save({"tensor": t})
    back = st_load(ours)["tensor"]
    assert back.dtype == dtype and torch.equal(back.view(torch.uint8),
                                               t.view(torch.uint8))
    got = interop.tensor_from_safetensors(st_save({"tensor": t}))
    assert got.dtype == dtype and got.shape == t.shape
    assert torch.equal(got.view(torch.uint8), t.view(torch.uint8))


# -- the cases of tests/test_interop.py on the port ----------------------------


def _reference_encode_extend(rid, input_ids, hidden, routing, lora=""):
    """An EXTEND ForwardRequest built the way the reference builds it (the
    generated bindings + safetensors.torch), not through either adapter."""
    msg = pb.ForwardRequest()
    msg.forward_mode = pb.ForwardMode.EXTEND
    r = msg.reqs.add()
    r.rid = rid
    r.output_length = 0
    r.input_ids.extend(input_ids)
    r.routing_table.extend(routing)
    r.sampling_params.max_new_tokens = 7
    r.sampling_params.temperature = 0.5
    r.sampling_params.top_p = 0.9
    r.sampling_params.top_k = 40
    r.sampling_params.stop_token_ids.extend([7, 9])
    r.sampling_params.repetition_penalty = 1.1
    r.sampling_params.json_schema = ""
    r.lora_path = lora
    r.hidden_states = st_save({"tensor": hidden})
    return msg.SerializeToString()


def test_decode_reference_encoded_extend():
    hidden = torch.randn(5, 16, generator=torch.Generator().manual_seed(0))
    data = _reference_encode_extend(
        "req-1", [11, 12, 13, 14, 15], hidden, ["nodeA", "nodeB"],
        lora="tenant-a")
    (ireq,) = interop.forward_bytes_to_ireqs(data)
    assert ireq.request_id == "req-1"
    assert ireq.context_len == 5 and ireq.num_new_tokens == 5
    assert ireq.token_ids == [11, 12, 13, 14, 15]
    assert ireq.cached_prefix_ids is None
    assert ireq.routing_table == ["nodeA", "nodeB"]
    assert ireq.lora_id == "tenant-a"
    assert torch.equal(ireq.hidden_states, hidden)
    sp = SamplingParams.from_dict(ireq.sampling_params)
    assert sp.max_new_tokens == 7
    assert sp.temperature == pytest.approx(0.5)
    assert sp.top_p == pytest.approx(0.9)
    assert sp.top_k == 40
    assert sp.stop_token_ids == (7, 9)
    assert sp.repetition_penalty == pytest.approx(1.1)


def test_decode_reference_encoded_bf16_hidden():
    """CUDA reference nodes ship bf16 activations: the port keeps them
    bf16, bit for bit (the JAX module upcasts to f32 for numpy)."""
    t = torch.arange(8, dtype=torch.bfloat16).reshape(2, 4) / 3
    msg = pb.ForwardRequest()
    msg.forward_mode = pb.ForwardMode.EXTEND
    r = msg.reqs.add()
    r.rid = "bf"
    r.input_ids.extend([1, 2])
    r.hidden_states = st_save({"tensor": t})
    (ireq,) = interop.forward_bytes_to_ireqs(msg.SerializeToString())
    assert ireq.hidden_states.dtype == torch.bfloat16
    assert torch.equal(ireq.hidden_states.view(torch.int16),
                       t.view(torch.int16))
    (jireq,) = jinterop.forward_bytes_to_ireqs(msg.SerializeToString())
    np.testing.assert_array_equal(jireq.hidden_states,
                                  ireq.hidden_states.float().numpy())


def test_decode_reference_encoded_decode_mode():
    msg = pb.ForwardRequest()
    msg.forward_mode = pb.ForwardMode.DECODE
    r = msg.reqs.add()
    r.rid = "d1"
    r.input_ids.extend([5, 6, 7])
    r.output_length = 2
    r.next_token_id = 42
    r.hidden_states = st_save({"tensor": torch.zeros(1, 8)})
    (ireq,) = interop.forward_bytes_to_ireqs(msg.SerializeToString())
    assert ireq.context_len == 5 and ireq.num_new_tokens == 1
    assert ireq.token_ids == [42]
    assert ireq.hidden_states.shape == (1, 8)


def test_decode_ring_closure_packet():
    msg = pb.ForwardRequest()
    msg.forward_mode = pb.ForwardMode.DECODE
    r = msg.reqs.add()
    r.rid = "c1"
    r.input_ids.extend([5, 6, 7])
    r.output_length = 3
    r.next_token_id = 99
    r.token_prob = -0.25
    (ireq,) = interop.forward_bytes_to_ireqs(msg.SerializeToString())
    assert ireq.hidden_states is None
    assert ireq.next_token_id == 99
    assert ireq.token_logprob == pytest.approx(-0.25)


def test_encode_round_trip_through_reference_schema():
    hidden = torch.randn(3, 8, generator=torch.Generator().manual_seed(1))
    src = IntermediateRequest(
        request_id="rt-1", routing_table=["a", "b"], context_len=6,
        num_new_tokens=3, token_ids=[4, 5, 6], hidden_states=hidden,
        sampling_params=SamplingParams(
            temperature=0.3, top_k=5, max_new_tokens=9,
            stop_token_ids=(2,)).to_dict(),
        lora_id="t1")
    data = interop.ireqs_to_forward_bytes(
        [src], full_input_ids={"rt-1": [1, 2, 3, 4, 5, 6]})
    msg = pb.ForwardRequest()
    msg.ParseFromString(data)
    assert msg.reqs[0].rid == "rt-1"
    assert list(msg.reqs[0].input_ids) == [1, 2, 3, 4, 5, 6]
    assert msg.reqs[0].output_length == 0
    assert msg.reqs[0].lora_path == "t1"
    (back,) = interop.forward_bytes_to_ireqs(data)
    assert back.request_id == src.request_id
    assert back.context_len == src.context_len
    assert back.num_new_tokens == src.num_new_tokens
    assert back.token_ids == src.token_ids
    # The hop starts past position 0: the skipped ids come back as the
    # head's prefix (the JAX decoder drops them).
    assert back.cached_prefix_ids == [1, 2, 3]
    assert torch.equal(back.hidden_states, hidden)
    assert back.lora_id == "t1"
    sp = SamplingParams.from_dict(back.sampling_params)
    assert sp.temperature == pytest.approx(0.3)
    assert (sp.top_k, sp.max_new_tokens) == (5, 9)
    assert sp.stop_token_ids == (2,)


def test_abort_round_trip():
    data = interop.rids_to_abort_bytes(["r1", "r2"])
    msg = pb.AbortRequest()
    msg.ParseFromString(data)
    assert [r.rid for r in msg.reqs] == ["r1", "r2"]
    assert interop.abort_bytes_to_rids(data) == ["r1", "r2"]


def _engines():
    return [StageEngine(create_stage_model(CFG, s, e),
                        _port_params(create_stage_model(CFG, s, e)),
                        EngineConfig(**ENGINE), device="cpu")
            for s, e in [(0, 2), (2, 4)]]


@pytest.mark.parametrize("tail_ids", [None, [30, 31, 32], [30]],
                         ids=["cold", "prefix-hit", "prefix-hit-one-token"])
def test_pipeline_through_protobuf_wire_matches_native(tail_ids):
    """Every stage-1 -> stage-2 packet through the reference protobuf
    bytes: the same tokens as the native path. With ``tail_ids`` a second
    request, a 16-token prefix of the first plus ``tail_ids``, rides a
    head that skipped its cached pages: the decoded ``cached_prefix_ids``
    put the tail's new mirror at the right positions (a one-token hop is
    encoded as a decode row and recovers it too)."""
    prefix_hit = tail_ids is not None
    prompts = [[1, 2, 3, 4, 5, 6, 7]] if not prefix_hit else [
        list(range(1, 21)), list(range(1, 17)) + tail_ids]

    def run(through):
        engines = _engines()
        if through:
            tail = engines[1]
            orig = tail.submit_intermediate

            def through_protobuf(ireq):
                data = interop.ireqs_to_forward_bytes(
                    [ireq], full_input_ids={
                        ireq.request_id: list(prompts[int(
                            ireq.request_id[1:])])})
                (decoded,) = interop.forward_bytes_to_ireqs(data)
                # The schema flags every hop a last chunk: re-attach the
                # packet-level flag, as the JAX case does.
                decoded.is_last_chunk = ireq.is_last_chunk
                orig(decoded)

            tail.submit_intermediate = through_protobuf
        pipe = InProcessPipeline(engines)
        out = []
        for i, p in enumerate(prompts):
            r = Request(f"w{i}", prompt_ids=list(p),
                        sampling_params=SamplingParams(temperature=0.0,
                                                       max_new_tokens=6))
            pipe.submit(r)
            pipe.run_until_complete()
            out.append(r)
        if prefix_hit:
            assert out[1].num_cached_tokens == 16
        return [r.output_ids for r in out]

    assert run(True) == run(False)


def test_decode_encode_preserves_fed_token():
    src = IntermediateRequest(
        request_id="d-1", context_len=9, num_new_tokens=1, token_ids=[77],
        hidden_states=torch.zeros(1, 8), sampling_params={},
        routing_table=[])
    data = interop.ireqs_to_forward_bytes(
        [src], full_input_ids={"d-1": [1, 2, 3, 4, 5]})
    msg = pb.ForwardRequest()
    msg.ParseFromString(data)
    assert msg.forward_mode == pb.ForwardMode.DECODE
    assert msg.reqs[0].next_token_id == 77
    (back,) = interop.forward_bytes_to_ireqs(data)
    assert back.token_ids == [77] and back.context_len == 9


def test_mixed_batch_round_trips_per_row_phase():
    pre = IntermediateRequest(
        request_id="p", context_len=4, num_new_tokens=4,
        token_ids=[1, 2, 3, 4], hidden_states=torch.zeros(4, 8),
        sampling_params={}, routing_table=[])
    dec = IntermediateRequest(
        request_id="d", context_len=7, num_new_tokens=1, token_ids=[55],
        hidden_states=torch.ones(1, 8), sampling_params={},
        routing_table=[])
    data = interop.ireqs_to_forward_bytes(
        [pre, dec], full_input_ids={"p": [1, 2, 3, 4], "d": [9, 8, 7]})
    msg = pb.ForwardRequest()
    msg.ParseFromString(data)
    assert msg.forward_mode == pb.ForwardMode.MIXED
    back_p, back_d = interop.forward_bytes_to_ireqs(data)
    assert back_p.num_new_tokens == 4 and back_p.token_ids == [1, 2, 3, 4]
    assert back_d.num_new_tokens == 1 and back_d.token_ids == [55]
    assert back_d.context_len == 7


def test_logprobs_flag_round_trips():
    src = IntermediateRequest(
        request_id="lp", context_len=3, num_new_tokens=3, token_ids=[1, 2, 3],
        hidden_states=torch.zeros(3, 4),
        sampling_params=SamplingParams(logprobs=True).to_dict(),
        routing_table=[])
    data = interop.ireqs_to_forward_bytes([src])
    msg = pb.ForwardRequest()
    msg.ParseFromString(data)
    assert msg.reqs[0].return_probs is True
    (back,) = interop.forward_bytes_to_ireqs(data)
    assert SamplingParams.from_dict(back.sampling_params).logprobs is True


def test_chunk_local_payload_keeps_tokens():
    src = IntermediateRequest(
        request_id="ch", context_len=8, num_new_tokens=4,
        token_ids=[5, 6, 7, 8], hidden_states=torch.zeros(4, 4),
        sampling_params={}, routing_table=[], is_last_chunk=False)
    data = interop.ireqs_to_forward_bytes([src])
    (back,) = interop.forward_bytes_to_ireqs(data)
    assert back.token_ids == [5, 6, 7, 8]
    assert back.context_len == 8 and back.num_new_tokens == 4
    assert back.cached_prefix_ids is None


# -- the same bytes as the JAX module ------------------------------------------


def _packets():
    g = np.random.default_rng(3)
    h = lambda n: g.standard_normal((n, 8)).astype(np.float32)  # noqa: E731
    sp = SamplingParams(temperature=0.7, top_k=20, top_p=0.9, min_p=0.05,
                        max_new_tokens=33, stop_token_ids=(2, 3),
                        stop_strings=("END",), repetition_penalty=1.2,
                        presence_penalty=0.5, frequency_penalty=-0.25,
                        logprobs=True, ignore_eos=True).to_dict()
    return [
        dict(request_id="pre", routing_table=["a:1", "relay:x@b:2"],
             context_len=6, num_new_tokens=3, token_ids=[4, 5, 6],
             hidden=h(3), sampling_params=sp, lora_id="t1"),
        dict(request_id="skip", routing_table=[], context_len=9,
             num_new_tokens=4, token_ids=[6, 7, 8, 9], hidden=h(4),
             cached_prefix_ids=[1, 2, 3, 4, 5], sampling_params={}),
        dict(request_id="dec", routing_table=["a:1"], context_len=12,
             num_new_tokens=1, token_ids=[-3], hidden=h(1),
             sampling_params={"temperature": 0.0}),
        dict(request_id="ring", routing_table=["a:1"], context_len=12,
             num_new_tokens=0, next_token_id=17, token_logprob=-1.5,
             hidden=None, sampling_params=sp),
    ]


@pytest.mark.parametrize("batch", [[0], [1], [2], [3], [0, 2], [0, 1, 2, 3]],
                         ids=["extend", "prefix-skip", "decode", "ring",
                              "mixed", "all"])
@pytest.mark.parametrize("full", [False, True], ids=["packet-ids",
                                                     "full-ids"])
def test_forward_bytes_equal_the_jax_module(batch, full):
    packets = [_packets()[i] for i in batch]
    full_ids = {p["request_id"]: list(range(1, 1 + p["context_len"]
                                            - (p["num_new_tokens"] == 1)))
                for p in packets} if full else None

    def make(cls, to_tensor):
        out = []
        for p in packets:
            kw = {k: v for k, v in p.items() if k != "hidden"}
            h = p["hidden"]
            out.append(cls(hidden_states=None if h is None
                           else to_tensor(h), **kw))
        return out

    ours = interop.ireqs_to_forward_bytes(make(IntermediateRequest,
                                               torch.from_numpy), full_ids)
    theirs = jinterop.ireqs_to_forward_bytes(make(JIReq, lambda x: x),
                                             full_ids)
    assert ours == theirs
    mine = interop.forward_bytes_to_ireqs(theirs)
    jaxs = jinterop.forward_bytes_to_ireqs(ours)
    assert len(mine) == len(jaxs) == len(packets)
    for a, b in zip(mine, jaxs):
        for k in ("request_id", "routing_table", "context_len",
                  "num_new_tokens", "token_ids", "next_token_id",
                  "token_logprob", "sampling_params", "is_last_chunk",
                  "lora_id"):
            assert getattr(a, k) == getattr(b, k), k
        if a.hidden_states is None:
            assert b.hidden_states is None
        else:
            np.testing.assert_array_equal(a.hidden_states.numpy(),
                                          b.hidden_states)


# -- a real worker over TCP ------------------------------------------------------


def test_worker_node_takes_protobuf_forward_and_abort_over_tcp():
    """A reference-protocol peer dials a port worker and sends raw
    protobuf bytes as the FORWARD / ABORT payloads; the worker decodes and
    queues them for its step loop (not started here, so the queue is read
    directly) and counts the bytes in its inbound stats; a malformed
    payload errors the RPC and the worker keeps serving."""
    server = TcpTransport("", "127.0.0.1")
    server.start()
    server.peer_id = server.address
    node = WorkerNode(server, None, CFG, EngineConfig(**ENGINE),
                      layers=(2, 4), device="cpu")
    peer = TcpTransport("ref-peer", "127.0.0.1")
    peer.start()
    try:
        msg = pb.ForwardRequest()
        msg.forward_mode = pb.ForwardMode.EXTEND
        r = msg.reqs.add()
        r.rid = "tcp-pb"
        r.input_ids.extend([1, 2, 3])
        r.hidden_states = st_save({"tensor": torch.ones(3, 64)})
        data = msg.SerializeToString()
        assert peer.call(server.address, proto.FORWARD, data,
                         timeout=10.0) == "ok"
        kind, ireq = node._inbox.get(timeout=5.0)
        assert kind == "forward" and ireq.request_id == "tcp-pb"
        assert torch.equal(ireq.hidden_states, torch.ones(3, 64))
        assert ireq.token_ids == [1, 2, 3] and ireq.is_last_chunk
        rx = node.transport_stats()["ref-peer"]
        assert rx["frames_in"] == 1 and rx["bytes_in"] == len(data)
        with pytest.raises(TransportError):
            peer.call(server.address, proto.FORWARD, b"\xff\xfe garbage",
                      timeout=10.0)
        assert peer.call(server.address, proto.ABORT,
                         interop.rids_to_abort_bytes(["x", "y"]),
                         timeout=10.0) == "ok"
        assert node._inbox.get(timeout=5.0) == ("release", "x", True)
        assert node._inbox.get(timeout=5.0) == ("release", "y", True)
        assert _wait(lambda: node._inbox.empty(), 1.0)
    finally:
        peer.stop()
        node.stop()
