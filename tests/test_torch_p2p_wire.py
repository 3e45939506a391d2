"""The port's wire (parallax_tpu_torch.p2p.{wire,proto}) against the JAX
package's (parallax_tpu.p2p.proto on msgpack): the codec writes
``msgpack.packb(x, use_bin_type=True)``'s bytes and reads them as
``msgpack.unpackb(x, raw=False)`` does, on hypothesis-drawn frames of the
supported types; tensor and FORWARD frames cross between the packages in
both directions bit for bit (f32, bf16, i32), legacy numpy-code frames
decode, the bf16 downcast restores the sender's dtype, and the float8 link
mode is refused by name."""

import math

import ml_dtypes
import msgpack
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from parallax_tpu.p2p import proto as jproto
from parallax_tpu.runtime.request import IntermediateRequest as JIReq
from parallax_tpu_torch.p2p import proto, wire
from parallax_tpu_torch.runtime.request import IntermediateRequest

_INT = st.integers(min_value=-(1 << 63), max_value=(1 << 64) - 1)
_EDGE_INTS = st.sampled_from([
    0, 1, 127, 128, 255, 256, 65535, 65536, (1 << 32) - 1, 1 << 32,
    (1 << 64) - 1, -1, -32, -33, -128, -129, -32768, -32769, -(1 << 31),
    -(1 << 31) - 1, -(1 << 63),
])
_SCALARS = (
    st.none() | st.booleans() | _INT | _EDGE_INTS
    | st.floats(allow_nan=False) | st.text(max_size=300)
    | st.binary(max_size=300)
)
_OBJ = st.recursive(
    _SCALARS,
    lambda kids: (st.lists(kids, max_size=20)
                  | st.dictionaries(st.text(max_size=40), kids, max_size=20)),
    max_leaves=60,
)


@settings(max_examples=300, deadline=None)
@given(_OBJ)
def test_codec_writes_msgpack_bytes_and_reads_them_back(obj):
    ref = msgpack.packb(obj, use_bin_type=True)
    assert wire.packb(obj) == ref
    assert wire.unpackb(ref) == msgpack.unpackb(ref, raw=False) == obj


@settings(max_examples=100, deadline=None)
@given(st.lists(st.tuples(_INT, st.text(max_size=5)), max_size=5),
       st.integers(min_value=0, max_value=70_000))
def test_codec_sizes_and_tuples(pairs, n):
    """Tuples pack as arrays; strings, bins, arrays and maps at every
    header width (fix / 8 / 16 / 32 bits)."""
    big = {"s": "x" * n, "b": b"\x01" * n, "a": list(range(n % 70)),
           "pairs": pairs, "t": tuple(pairs)}
    assert wire.packb(big) == msgpack.packb(big, use_bin_type=True)
    assert wire.unpackb(msgpack.packb(big, use_bin_type=True)) == \
        msgpack.unpackb(msgpack.packb(big, use_bin_type=True), raw=False)
    wide = {str(i): i for i in range(n % 40)}
    assert wire.packb(wide) == msgpack.packb(wide, use_bin_type=True)
    assert wire.packb([0] * 70_000) == msgpack.packb([0] * 70_000)


def test_codec_refuses_what_msgpack_refuses():
    for bad in (object(), {1, 2}, np.int64(3), np.bool_(True), 1 + 2j):
        with pytest.raises(TypeError):
            wire.packb(bad)
    for big in (1 << 64, -(1 << 63) - 1):
        with pytest.raises(OverflowError):
            wire.packb(big)
    ref = msgpack.packb({"a": 1})
    with pytest.raises(ValueError, match="extra data"):
        wire.unpackb(ref + b"\x00")
    with pytest.raises(ValueError, match="truncated"):
        wire.unpackb(ref[:-1])
    # Non-string map keys: msgpack.unpackb's strict_map_key default.
    with pytest.raises(ValueError):
        wire.unpackb(msgpack.packb({1: 2}))
    # float32 and the other forms a foreign packer may write decode.
    for x in (1.5, -7, 300):
        for raw in (msgpack.packb(x, use_single_float=True),):
            assert wire.unpackb(raw) == msgpack.unpackb(raw)
    assert wire.unpackb(b"\xd0\x05") == 5          # int8 form of 5
    assert wire.unpackb(b"\xca\x3f\xc0\x00\x00") == 1.5


def test_frames_byte_identical_to_jax():
    payload = {"reqs": [{"rid": "r0", "routing_table": ["a:1", "b:2"],
                         "token_ids": [1, 2, 3], "x": None, "f": 0.25,
                         "data": b"\x00\xff" * 40}]}
    for t, mid, re in (("rpc_pp_forward", 0, None), ("__reply__", 7, 3)):
        got = proto.encode_frame(t, payload, msg_id=mid, reply_to=re)
        assert got == jproto.encode_frame(t, payload, msg_id=mid,
                                          reply_to=re)
        assert proto.decode_frame(got) == jproto.decode_frame(got)
    nan = proto.decode_frame(jproto.encode_frame("t", float("nan")))["p"]
    assert math.isnan(nan)


def _arrays():
    rng = np.random.default_rng(3)
    f32 = rng.standard_normal((5, 7)).astype(np.float32)
    f32[0, :3] = [np.inf, -0.0, np.float32(1e-40)]     # inf, -0, denormal
    return {
        "float32": f32,
        "bfloat16": rng.standard_normal((3, 64)).astype(ml_dtypes.bfloat16),
        "int32": rng.integers(-2**31, 2**31 - 1, (4, 9), dtype=np.int32),
    }


def _to_torch(a: np.ndarray) -> torch.Tensor:
    if a.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def _bits(t: torch.Tensor) -> np.ndarray:
    if t.dtype == torch.bfloat16:
        t = t.view(torch.int16)
    return t.numpy()


def _np_bits(a: np.ndarray) -> np.ndarray:
    return a.view(np.int16) if a.dtype == ml_dtypes.bfloat16 else a


@pytest.mark.parametrize("name", ["float32", "bfloat16", "int32"])
def test_tensor_frames_cross_both_ways_bit_for_bit(name):
    a = _arrays()[name]
    t = _to_torch(a)
    # JAX -> port.
    frame = jproto.encode_frame("t", jproto.tensor_to_wire(a))
    back = proto.tensor_from_wire(proto.decode_frame(frame)["p"])
    assert back.dtype == t.dtype and list(back.shape) == list(a.shape)
    assert np.array_equal(_bits(back), _np_bits(a))
    back[0] = back[0]      # the decoded tensor owns writable memory
    # port -> JAX: the same bytes on the wire.
    ours = proto.encode_frame("t", proto.tensor_to_wire(t))
    assert ours == frame
    arr = jproto.tensor_from_wire(jproto.decode_frame(ours)["p"])
    assert arr.dtype == a.dtype
    assert np.array_equal(_np_bits(arr), _np_bits(a))
    assert proto.tensor_nbytes(proto.tensor_to_wire(t)) == a.nbytes


def test_legacy_code_frames_decode():
    a = _arrays()["float32"]
    legacy = {"dtype": a.dtype.str, "shape": list(a.shape),
              "data": a.tobytes()}
    assert legacy["dtype"] == "<f4"
    back = proto.tensor_from_wire(proto.decode_frame(
        jproto.encode_frame("t", legacy))["p"])
    assert back.dtype == torch.float32 and np.array_equal(back.numpy(), a)
    i32 = _arrays()["int32"]
    back = proto.tensor_from_wire({"dtype": "<i4", "shape": [4, 9],
                                   "data": i32.tobytes()})
    assert np.array_equal(back.numpy(), i32)


def test_bf16_downcast_restores_the_senders_dtype():
    a = _arrays()["float32"]
    t = _to_torch(a)
    ours = proto.tensor_to_wire(t, "bfloat16")
    theirs = jproto.tensor_to_wire(a, "bfloat16")
    assert ours == theirs
    assert ours["dtype"] == "bfloat16" and ours["odtype"] == "float32"
    assert proto.tensor_nbytes(ours) == a.size * 2
    back = proto.tensor_from_wire(ours)
    ref = jproto.tensor_from_wire(theirs)
    assert back.dtype == torch.float32 and ref.dtype == np.float32
    assert np.array_equal(back.numpy(), ref, equal_nan=True)
    # Integer tensors ship verbatim whatever the link mode.
    i32 = _to_torch(_arrays()["int32"])
    assert proto.tensor_to_wire(i32, "bfloat16")["dtype"] == "int32"


def test_float8_link_mode_is_refused_by_name():
    """The float8 link mode, once refused by name, is ported: for bf16 and
    f32 inputs the port's frame equals the JAX package's byte for byte
    (data, per-token f32 scales, odtype), each side decodes the other's to
    the same values, and both builds advertise the same dtype names."""
    for name in ("bfloat16", "float32"):
        # Finite rows (row 0 of the f32 case holds an inf).
        a = _arrays()[name][1:]
        ours = proto.tensor_to_wire(_to_torch(a), "float8_e4m3fn")
        theirs = jproto.tensor_to_wire(a, "float8_e4m3fn")
        assert set(ours) == set(theirs)
        for key in ("dtype", "shape", "odtype", "data", "scales"):
            assert ours[key] == theirs[key], (name, key)
        assert proto.tensor_nbytes(ours) == jproto.tensor_nbytes(theirs)
        back = proto.tensor_from_wire(theirs)
        ref = jproto.tensor_from_wire(ours)
        assert back.dtype == getattr(torch, name)
        assert np.array_equal(back.float().numpy(),
                              np.asarray(ref).astype(np.float32))
    assert "float8_e4m3fn" in proto.WIRE_DTYPES
    assert set(proto.WIRE_DTYPES) == set(jproto.WIRE_DTYPES)
    # Integer tensors ship verbatim in the float8 mode too.
    i32 = _to_torch(_arrays()["int32"])
    assert proto.tensor_to_wire(i32, "float8_e4m3fn")["dtype"] == "int32"


def _ireq_pair():
    h = _arrays()["bfloat16"][:3]
    kw = dict(request_id="r7", routing_table=["10.0.0.1:7000", "b:1"],
              context_len=300, num_new_tokens=3, token_ids=[5, 6, 7],
              sampling_params={"temperature": 0.0, "max_new_tokens": 32},
              is_last_chunk=False, cached_prefix_ids=[1, 2])
    return (JIReq(hidden_states=h, **kw),
            IntermediateRequest(hidden_states=_to_torch(h), **kw), h)


def test_forward_frames_cross_both_ways():
    jreq, preq, h = _ireq_pair()
    frame_j = jproto.encode_frame(
        jproto.FORWARD, {"reqs": [jproto.ireq_to_wire(jreq)]})
    frame_p = proto.encode_frame(
        proto.FORWARD, {"reqs": [proto.ireq_to_wire(preq)]})
    assert frame_p == frame_j
    got = proto.ireq_from_wire(proto.decode_frame(frame_j)["p"]["reqs"][0])
    want = jproto.ireq_from_wire(jproto.decode_frame(frame_p)["p"]["reqs"][0])
    for f in ("request_id", "routing_table", "context_len", "num_new_tokens",
              "token_ids", "sampling_params", "is_last_chunk",
              "cached_prefix_ids", "next_token_id", "spec_len"):
        assert getattr(got, f) == getattr(want, f) == getattr(jreq, f), f
    assert got.hidden_states.dtype == torch.bfloat16
    assert np.array_equal(_bits(got.hidden_states), h.view(np.int16))
    assert np.array_equal(want.hidden_states.view(np.int16),
                          h.view(np.int16))
    # The ring's token hop (no tensor) too.
    tok = IntermediateRequest("r7", ["a:1"], 301, 1, next_token_id=42)
    frame = proto.encode_frame(proto.FORWARD,
                               {"reqs": [proto.ireq_to_wire(tok)]})
    back = jproto.ireq_from_wire(jproto.decode_frame(frame)["p"]["reqs"][0])
    assert back.next_token_id == 42 and back.hidden_states is None
