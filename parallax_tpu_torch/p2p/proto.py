"""Wire format: msgpack frames with raw-bytes tensor payloads (port of
``parallax_tpu/p2p/proto.py``).

The frames are the JAX package's, byte for byte: ``{"t", "id", "re",
"p"}`` packed as ``msgpack.packb(..., use_bin_type=True)`` packs them
(through ``p2p/wire.py``, the port's own codec), tensors as ``{dtype:
name, shape, data: raw bytes}`` with the dtype by its JAX / numpy NAME.
So a JAX stage and a port stage decode each other's FORWARD frames. The
tensors here are CPU torch tensors: bf16 leaves through a 16-bit view and
comes back through ``torch.frombuffer`` over a writable copy of the bytes.

Native frames, the ``bfloat16`` downcast (``odtype`` restores the sender's
dtype on receipt) and the ``float8_e4m3fn`` link mode, which quantizes each
token's row with its own f32 scale (``ops/quant.py``; the frame carries
``scales`` and ``odtype``, byte for byte the JAX package's); legacy numpy
type codes (``'<f4'``) decode.
"""

from __future__ import annotations

from typing import Any

import torch

from parallax_tpu_torch.ops.quant import (
    dequantize_fp8_per_token,
    quantize_fp8_per_token,
)
from parallax_tpu_torch.p2p import wire
from parallax_tpu_torch.runtime.request import IntermediateRequest

# Frame types (the RPC surface, names as in the JAX package).
FORWARD = "rpc_pp_forward"
ABORT = "rpc_abort"
RELEASE = "rpc_release"
NODE_JOIN = "node_join"
NODE_UPDATE = "node_update"
NODE_LEAVE = "node_leave"
# Frontend <-> head request serving (submit / poll / stop / readiness).
CHAT_SUBMIT = "chat_submit"
CHAT_POLL = "chat_poll"
CHAT_STOP = "chat_stop"
CHAT_READY = "chat_ready"
REQUEST_COMPLETE = "request_complete"
MIGRATION_DONE = "migration_done"
WHERE_IS = "where_is"
# Per-link wire-format negotiation (sender asks, receiver answers with
# the dtype names it can decode).
WIRE_CAPS = "wire_caps"
CHECKPOINT = "rpc_checkpoint"
PEER_DOWN = "peer_down"
MIGRATE_TARGET = "migrate_target"
KV_TRANSFER = "rpc_kv_transfer"
KV_RESULT = "kv_handoff_result"
DISAGG_TARGET = "disagg_target"
HA_JOURNAL = "ha_journal"
HA_SYNC = "ha_sync"
ROUTE_REQUEST = "route_request"
PROFILE = "rpc_profile"

# Wire dtype name -> torch dtype (the JAX package's names, float8 ones
# included).
_NAME_TO_DTYPE = {
    "float16": torch.float16, "float32": torch.float32,
    "float64": torch.float64, "bfloat16": torch.bfloat16,
    "int8": torch.int8, "int16": torch.int16, "int32": torch.int32,
    "int64": torch.int64, "uint8": torch.uint8, "uint16": torch.uint16,
    "uint32": torch.uint32, "uint64": torch.uint64, "bool": torch.bool,
    "float8_e4m3fn": torch.float8_e4m3fn, "float8_e5m2": torch.float8_e5m2,
}
_DTYPE_TO_NAME = {v: k for k, v in _NAME_TO_DTYPE.items()}
# numpy type codes of legacy frames -> wire names (standard dtypes only:
# extension types never round-trip through codes).
_LEGACY_CODES = {
    "<f2": "float16", "<f4": "float32", "<f8": "float64",
    "|i1": "int8", "<i2": "int16", "<i4": "int32", "<i8": "int64",
    "|u1": "uint8", "<u2": "uint16", "<u4": "uint32", "<u8": "uint64",
    "|b1": "bool",
}
# Same-width integer views that carry a dtype's bytes through numpy.
_BITS_VIEW = {torch.bfloat16: torch.int16, torch.uint16: torch.int16,
              torch.uint32: torch.int32, torch.uint64: torch.int64,
              torch.float8_e4m3fn: torch.uint8,
              torch.float8_e5m2: torch.uint8}

# Dtype names this build can decode (advertised in wire_caps replies).
WIRE_DTYPES = tuple(sorted(_NAME_TO_DTYPE))

# Dtypes eligible for lossy wire conversion (activations); integer and
# bool tensors always ship verbatim.
_FLOAT_NAMES = frozenset(("float16", "float32", "float64", "bfloat16"))


def dtype_name(dtype: torch.dtype) -> str:
    """The wire name of a torch dtype (the JAX / numpy name)."""
    try:
        return _DTYPE_TO_NAME[dtype]
    except KeyError:
        raise TypeError(f"no wire name for {dtype}") from None


def resolve_dtype(name: str) -> torch.dtype:
    """The torch dtype of a wire name or a legacy numpy type code."""
    dt = _NAME_TO_DTYPE.get(_LEGACY_CODES.get(name, name))
    if dt is not None:
        return dt
    raise TypeError(f"unknown wire dtype {name!r}")


def _to_bytes(t: torch.Tensor) -> bytes:
    t = t.contiguous()
    view = _BITS_VIEW.get(t.dtype)
    if view is not None:
        t = t.view(view)
    return t.numpy().tobytes()


def tensor_to_wire(t: torch.Tensor | None,
                   wire_dtype: str | None = None) -> dict | None:
    """Serialize one CPU tensor, optionally converting float payloads to a
    cheaper wire dtype. ``wire_dtype=None`` ships the bytes verbatim
    (bit-identical streams); ``"bfloat16"`` downcasts on the wire;
    ``"float8_e4m3fn"`` compresses with per-token scales. Both record the
    original dtype in ``odtype``."""
    if t is None:
        return None
    if t.device.type != "cpu":
        raise ValueError(f"tensor_to_wire takes CPU tensors, got {t.device}")
    name = dtype_name(t.dtype)
    if wire_dtype and wire_dtype != name and name in _FLOAT_NAMES:
        if wire_dtype == "float8_e4m3fn":
            q, scales = quantize_fp8_per_token(t)
            return {
                "dtype": "float8_e4m3fn",
                "shape": list(t.shape),
                "data": _to_bytes(q),
                "scales": _to_bytes(scales),
                "odtype": name,
            }
        return {
            "dtype": wire_dtype,
            "shape": list(t.shape),
            "data": _to_bytes(t.to(resolve_dtype(wire_dtype))),
            "odtype": name,
        }
    return {"dtype": name, "shape": list(t.shape), "data": _to_bytes(t)}


def _from_bytes(data, dtype: torch.dtype, shape: list) -> torch.Tensor:
    if len(data):
        return torch.frombuffer(bytearray(data), dtype=dtype).reshape(shape)
    return torch.empty(shape, dtype=dtype)


def tensor_from_wire(obj: dict | None) -> torch.Tensor | None:
    """A CPU tensor that owns a writable copy of the frame's bytes."""
    if obj is None:
        return None
    dtype = resolve_dtype(obj["dtype"])
    shape = list(obj["shape"])
    t = _from_bytes(obj["data"], dtype, shape)
    odtype = obj.get("odtype")
    if obj.get("scales") is not None:
        scales = _from_bytes(obj["scales"], torch.float32, shape[:-1])
        return dequantize_fp8_per_token(
            t, scales, resolve_dtype(odtype or "float32"))
    if odtype and odtype != obj["dtype"]:
        # Plain downcast frame: restore the sender's working precision.
        t = t.to(resolve_dtype(odtype))
    return t


def tensor_nbytes(obj: dict | None) -> int:
    """Payload bytes of one wire tensor frame (data + scales)."""
    if obj is None:
        return 0
    return len(obj["data"]) + len(obj.get("scales") or b"")


def ireq_to_wire(ireq: IntermediateRequest,
                 wire_dtype: str | None = None) -> dict:
    return {
        "rid": ireq.request_id,
        "routing_table": list(ireq.routing_table),
        "context_len": ireq.context_len,
        "num_new_tokens": ireq.num_new_tokens,
        "token_ids": ireq.token_ids,
        "hidden_states": tensor_to_wire(ireq.hidden_states, wire_dtype),
        "next_token_id": ireq.next_token_id,
        "token_logprob": ireq.token_logprob,
        "sampling_params": ireq.sampling_params,
        "is_last_chunk": ireq.is_last_chunk,
        "abort": ireq.abort,
        "spec_len": ireq.spec_len,
        "spec_accepted": ireq.spec_accepted,
        "cached_prefix_ids": ireq.cached_prefix_ids,
        "lora_id": ireq.lora_id,
        "trace": ireq.trace,
        "qos": ireq.qos_class,
    }


def ireq_from_wire(d: dict) -> IntermediateRequest:
    return IntermediateRequest(
        request_id=d["rid"],
        routing_table=list(d.get("routing_table") or []),
        context_len=d["context_len"],
        num_new_tokens=d["num_new_tokens"],
        token_ids=d.get("token_ids"),
        hidden_states=tensor_from_wire(d.get("hidden_states")),
        next_token_id=d.get("next_token_id"),
        token_logprob=d.get("token_logprob"),
        sampling_params=d.get("sampling_params"),
        is_last_chunk=d.get("is_last_chunk", True),
        abort=d.get("abort", False),
        spec_len=d.get("spec_len", 0),
        spec_accepted=d.get("spec_accepted"),
        cached_prefix_ids=d.get("cached_prefix_ids"),
        lora_id=d.get("lora_id"),
        trace=bool(d.get("trace", False)),
        qos_class=d.get("qos"),
    )


def encode_frame(frame_type: str, payload: Any, msg_id: int = 0,
                 reply_to: int | None = None) -> bytes:
    return wire.packb(
        {"t": frame_type, "id": msg_id, "re": reply_to, "p": payload})


def decode_frame(data: bytes) -> dict:
    return wire.unpackb(data)
