"""A proto3 codec for the five messages of the reference interop schema.

The schema is ``parallax_tpu/p2p/interop.proto`` (the reference swarm's
``forward.proto``): ``ForwardRequest``, ``AbortRequest``, ``Req``,
``SamplingParams`` and the ``ForwardMode`` enum. The JAX package generates
its bindings with ``protoc`` at first use; the port has neither
``protobuf`` nor ``protoc`` on the card, so it encodes and decodes the
wire format itself.

Messages are plain dicts keyed by field name. :func:`encode` writes the
bytes protobuf's own serializer writes: fields in number order, each
field at its default value omitted (0, 0.0 by its bits, False, "", b"",
an empty repeated field), repeated ``int32`` packed, a negative ``int32``
as the 10-byte varint of its 64-bit two's complement, ``float`` as
little-endian fixed32, a nested message written whenever its key holds a
dict (an empty one too: protobuf's presence of a set message), and the
proto3 ``optional float token_prob`` written whenever it is not None
(0.0 included). :func:`decode` fills every field: scalars with their
defaults, repeated fields with lists, an absent message or optional
field with None; it skips unknown fields of every wire type but groups,
reads repeated ``int32`` packed or not, and merges a message field that
occurs twice, as protobuf's parser does.
"""

from __future__ import annotations

import struct
from typing import NamedTuple

# ForwardMode enum values.
EXTEND = 0
DECODE = 1
MIXED = 2

_VARINT, _FIXED64, _LEN, _SGROUP, _EGROUP, _FIXED32 = 0, 1, 2, 3, 4, 5


class Field(NamedTuple):
    number: int
    name: str
    kind: str          # int32, enum, bool, float, string, bytes or a message
    repeated: bool = False
    optional: bool = False


_SCALARS = ("int32", "enum", "bool", "float", "string", "bytes")

SCHEMA: dict[str, tuple[Field, ...]] = {
    "ForwardRequest": (
        Field(1, "forward_mode", "enum"),
        Field(2, "reqs", "Req", repeated=True),
    ),
    "AbortRequest": (
        Field(1, "reqs", "Req", repeated=True),
    ),
    "Req": (
        Field(1, "rid", "string"),
        Field(2, "output_length", "int32"),
        Field(3, "routing_table", "string", repeated=True),
        Field(4, "input_ids", "int32", repeated=True),
        Field(5, "sampling_params", "SamplingParams"),
        Field(6, "next_token_id", "int32"),
        Field(7, "hidden_states", "bytes"),
        Field(8, "lora_path", "string"),
        Field(9, "token_prob", "float", optional=True),
        Field(10, "return_probs", "bool"),
    ),
    "SamplingParams": (
        Field(1, "max_new_tokens", "int32"),
        Field(2, "min_new_tokens", "int32"),
        Field(3, "temperature", "float"),
        Field(4, "top_p", "float"),
        Field(5, "min_p", "float"),
        Field(6, "top_k", "int32"),
        Field(7, "stop_token_ids", "int32", repeated=True),
        Field(8, "ignore_eos", "bool"),
        Field(9, "stop_strs", "string", repeated=True),
        Field(10, "repetition_penalty", "float"),
        Field(11, "presence_penalty", "float"),
        Field(12, "frequency_penalty", "float"),
        Field(13, "json_schema", "string"),
    ),
}
_BY_NUMBER = {m: {f.number: f for f in fields}
              for m, fields in SCHEMA.items()}


class DecodeError(ValueError):
    pass


# -- primitives ---------------------------------------------------------------


def _varint(n: int) -> bytes:
    n &= (1 << 64) - 1
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _int32(v) -> int:
    v = int(v)
    if not -(1 << 31) <= v < (1 << 31):
        raise ValueError(f"int32 out of range: {v}")
    return v


def _f32(v) -> bytes:
    return struct.pack("<f", float(v))


def _tag(number: int, wire_type: int) -> bytes:
    return _varint(number << 3 | wire_type)


def _read_varint(buf: memoryview, pos: int) -> tuple[int, int]:
    result = shift = 0
    while True:
        if pos >= len(buf):
            raise DecodeError("truncated varint")
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7
        if shift >= 70:
            raise DecodeError("varint too long")


def _as_int32(n: int) -> int:
    n &= 0xFFFFFFFF
    return n - (1 << 32) if n & 0x80000000 else n


# -- encode --------------------------------------------------------------------


def _default(f: Field):
    if f.repeated:
        return []
    if f.optional or f.kind not in _SCALARS:
        return None
    return {"int32": 0, "enum": 0, "bool": False, "float": 0.0,
            "string": "", "bytes": b""}[f.kind]


def _scalar(f: Field, v) -> bytes:
    """One present scalar value, tag included."""
    if f.kind in ("int32", "enum"):
        return _tag(f.number, _VARINT) + _varint(_int32(v))
    if f.kind == "bool":
        return _tag(f.number, _VARINT) + _varint(1 if v else 0)
    if f.kind == "float":
        return _tag(f.number, _FIXED32) + _f32(v)
    data = v.encode("utf-8") if f.kind == "string" else bytes(v)
    return _tag(f.number, _LEN) + _varint(len(data)) + data


def _is_default(f: Field, v) -> bool:
    if f.kind == "float":
        return _f32(v) == b"\0\0\0\0"
    if f.kind in ("int32", "enum"):
        return int(v) == 0
    if f.kind == "bool":
        return not v
    return len(v) == 0


def encode(message: str, d: dict) -> bytes:
    """``d`` (a dict of ``message``'s fields; missing keys are defaults)
    as protobuf's wire bytes."""
    out = bytearray()
    for f in SCHEMA[message]:
        v = d.get(f.name)
        if v is None:
            continue
        if f.kind not in _SCALARS:
            if f.repeated:
                for item in v:
                    body = encode(f.kind, item)
                    out += _tag(f.number, _LEN) + _varint(len(body)) + body
            else:
                body = encode(f.kind, v)
                out += _tag(f.number, _LEN) + _varint(len(body)) + body
        elif f.repeated:
            if f.kind in ("int32", "enum"):
                if len(v):
                    body = b"".join(_varint(_int32(x)) for x in v)
                    out += _tag(f.number, _LEN) + _varint(len(body)) + body
            else:
                for item in v:
                    out += _scalar(f, item)
        elif f.optional or not _is_default(f, v):
            out += _scalar(f, v)
    return bytes(out)


# -- decode --------------------------------------------------------------------


def _skip(buf: memoryview, pos: int, wire_type: int) -> int:
    if wire_type == _VARINT:
        return _read_varint(buf, pos)[1]
    if wire_type == _FIXED64:
        pos += 8
    elif wire_type == _FIXED32:
        pos += 4
    elif wire_type == _LEN:
        n, pos = _read_varint(buf, pos)
        pos += n
    else:
        raise DecodeError(f"unsupported wire type {wire_type}")
    if pos > len(buf):
        raise DecodeError("truncated field")
    return pos


def _decode_into(message: str, buf: memoryview, out: dict) -> dict:
    fields = _BY_NUMBER[message]
    pos = 0
    while pos < len(buf):
        key, pos = _read_varint(buf, pos)
        number, wire_type = key >> 3, key & 7
        if number == 0:
            raise DecodeError("field number 0")
        f = fields.get(number)
        if f is None:
            pos = _skip(buf, pos, wire_type)
            continue
        if f.kind in ("int32", "enum", "bool"):
            if wire_type == _LEN and f.repeated:
                n, pos = _read_varint(buf, pos)
                end = pos + n
                if end > len(buf):
                    raise DecodeError("truncated packed field")
                while pos < end:
                    x, pos = _read_varint(buf, pos)
                    out[f.name].append(_as_int32(x))
                if pos != end:
                    raise DecodeError("packed field overruns its length")
                continue
            if wire_type != _VARINT:
                raise DecodeError(f"{message}.{f.name}: wire type "
                                  f"{wire_type}")
            x, pos = _read_varint(buf, pos)
            value = bool(x) if f.kind == "bool" else _as_int32(x)
        elif f.kind == "float":
            if wire_type != _FIXED32 or pos + 4 > len(buf):
                raise DecodeError(f"{message}.{f.name}: bad float")
            (value,) = struct.unpack_from("<f", buf, pos)
            pos += 4
        else:
            if wire_type != _LEN:
                raise DecodeError(f"{message}.{f.name}: wire type "
                                  f"{wire_type}")
            n, pos = _read_varint(buf, pos)
            if pos + n > len(buf):
                raise DecodeError(f"{message}.{f.name}: truncated")
            chunk = buf[pos:pos + n]
            pos += n
            if f.kind == "string":
                try:
                    value = bytes(chunk).decode("utf-8")
                except UnicodeDecodeError as e:
                    raise DecodeError(f"{message}.{f.name}: {e}") from None
            elif f.kind == "bytes":
                value = bytes(chunk)
            elif f.repeated:
                value = _decode_into(f.kind, chunk, _empty(f.kind))
            else:
                prev = out[f.name]
                out[f.name] = _decode_into(
                    f.kind, chunk, prev if prev is not None
                    else _empty(f.kind))
                continue
        if f.repeated:
            out[f.name].append(value)
        else:
            out[f.name] = value
    return out


def _empty(message: str) -> dict:
    return {f.name: _default(f) for f in SCHEMA[message]}


def decode(message: str, data: bytes) -> dict:
    """``message``'s fields from protobuf wire bytes (see the module
    docstring); raises :class:`DecodeError` on malformed bytes."""
    return _decode_into(message, memoryview(bytes(data)), _empty(message))
