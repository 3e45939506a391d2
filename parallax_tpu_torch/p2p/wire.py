"""A msgpack codec for the subset of types the swarm's frames carry.

``packb(obj)`` writes exactly the bytes of ``msgpack.packb(obj,
use_bin_type=True)`` and ``unpackb(data)`` reads them back as
``msgpack.unpackb(data, raw=False)`` does, for ``None``, ``bool``, ``int``
(int64 / uint64 range), ``float`` (as float64), ``str``, ``bytes`` (as
bin), ``list`` / ``tuple`` and ``dict``. Any other type raises
``TypeError``. The frames of ``p2p/proto.py`` need no more; the card's
Python has no ``msgpack`` package, so the port keeps this standard-library
codec, as ``models/loader.py`` keeps its own safetensors reader.

Every width choice follows msgpack-python's packer: the smallest fixed
form, unsigned forms for non-negative integers, ``str8`` for strings (the
bin-type dialect), tuples as arrays. The reader also takes float32 and
the signed / unsigned forms a packer of another language may choose.
"""

from __future__ import annotations

import struct

_PACK_B = struct.Struct(">B").pack
_PACK_H = struct.Struct(">H").pack
_PACK_I = struct.Struct(">I").pack
_PACK_Q = struct.Struct(">Q").pack
_PACK_b = struct.Struct(">b").pack
_PACK_h = struct.Struct(">h").pack
_PACK_i = struct.Struct(">i").pack
_PACK_q = struct.Struct(">q").pack
_PACK_d = struct.Struct(">d").pack


def _head(out: list, n: int, fix: int | None, fix_max: int,
          c8: int | None, c16: int, c32: int) -> None:
    """A length header: the fix form below ``fix_max``, else 8 / 16 / 32
    bits (``None`` where the family has no such form)."""
    if fix is not None and n < fix_max:
        out.append(_PACK_B(fix | n))
    elif c8 is not None and n < 0x100:
        out.append(bytes((c8, n)))
    elif n < 0x10000:
        out.append(_PACK_B(c16) + _PACK_H(n))
    elif n < 0x100000000:
        out.append(_PACK_B(c32) + _PACK_I(n))
    else:
        raise ValueError(f"msgpack: length {n} does not fit 32 bits")


def _int(out: list, v: int) -> None:
    if 0 <= v < 0x80:
        out.append(_PACK_B(v))
    elif -32 <= v < 0:
        out.append(_PACK_B(0x100 + v))
    elif v >= 0:
        if v < 0x100:
            out.append(b"\xcc" + _PACK_B(v))
        elif v < 0x10000:
            out.append(b"\xcd" + _PACK_H(v))
        elif v < 0x100000000:
            out.append(b"\xce" + _PACK_I(v))
        elif v < 0x10000000000000000:
            out.append(b"\xcf" + _PACK_Q(v))
        else:
            raise OverflowError("Integer value out of range")
    elif v >= -0x80:
        out.append(b"\xd0" + _PACK_b(v))
    elif v >= -0x8000:
        out.append(b"\xd1" + _PACK_h(v))
    elif v >= -0x80000000:
        out.append(b"\xd2" + _PACK_i(v))
    elif v >= -0x8000000000000000:
        out.append(b"\xd3" + _PACK_q(v))
    else:
        raise OverflowError("Integer value out of range")


def _pack(out: list, obj) -> None:
    if obj is None:
        out.append(b"\xc0")
    elif obj is True:
        out.append(b"\xc3")
    elif obj is False:
        out.append(b"\xc2")
    elif isinstance(obj, int):
        _int(out, obj)
    elif isinstance(obj, float):
        out.append(b"\xcb" + _PACK_d(obj))
    elif isinstance(obj, (bytes, bytearray, memoryview)):
        data = bytes(obj) if isinstance(obj, memoryview) else obj
        _head(out, len(data), None, 0, 0xC4, 0xC5, 0xC6)
        out.append(data)
    elif isinstance(obj, str):
        data = obj.encode("utf-8")
        _head(out, len(data), 0xA0, 32, 0xD9, 0xDA, 0xDB)
        out.append(data)
    elif isinstance(obj, (list, tuple)):
        _head(out, len(obj), 0x90, 16, None, 0xDC, 0xDD)
        for item in obj:
            _pack(out, item)
    elif isinstance(obj, dict):
        _head(out, len(obj), 0x80, 16, None, 0xDE, 0xDF)
        for k, v in obj.items():
            _pack(out, k)
            _pack(out, v)
    else:
        raise TypeError(f"can not serialize {type(obj).__name__!r} object")


def packb(obj) -> bytes:
    """``msgpack.packb(obj, use_bin_type=True)``."""
    out: list[bytes] = []
    _pack(out, obj)
    return b"".join(out)


# -- reading -----------------------------------------------------------------

_FIXED = {
    # code -> (struct format, byte width) of the fixed-width scalars.
    0xCA: (">f", 4), 0xCB: (">d", 8),
    0xCC: (">B", 1), 0xCD: (">H", 2), 0xCE: (">I", 4), 0xCF: (">Q", 8),
    0xD0: (">b", 1), 0xD1: (">h", 2), 0xD2: (">i", 4), 0xD3: (">q", 8),
}
# code -> (kind, length width in bytes) of the sized families.
_SIZED = {
    0xC4: ("bin", 1), 0xC5: ("bin", 2), 0xC6: ("bin", 4),
    0xD9: ("str", 1), 0xDA: ("str", 2), 0xDB: ("str", 4),
    0xDC: ("array", 2), 0xDD: ("array", 4),
    0xDE: ("map", 2), 0xDF: ("map", 4),
}


class _Reader:
    def __init__(self, data):
        self.buf = memoryview(data).cast("B")
        self.pos = 0

    def take(self, n: int) -> memoryview:
        end = self.pos + n
        if end > len(self.buf):
            raise ValueError("msgpack: truncated data")
        view = self.buf[self.pos:end]
        self.pos = end
        return view

    def length(self, width: int) -> int:
        return int.from_bytes(self.take(width), "big")

    def value(self):
        code = self.take(1)[0]
        if code < 0x80:
            return code
        if code >= 0xE0:
            return code - 0x100
        if code < 0x90:
            return self.map(code & 0x0F)
        if code < 0xA0:
            return self.array(code & 0x0F)
        if code < 0xC0:
            return self.str(code & 0x1F)
        if code == 0xC0:
            return None
        if code == 0xC2:
            return False
        if code == 0xC3:
            return True
        fixed = _FIXED.get(code)
        if fixed is not None:
            fmt, width = fixed
            return struct.unpack(fmt, self.take(width))[0]
        sized = _SIZED.get(code)
        if sized is None:
            raise ValueError(f"msgpack: unsupported type code 0x{code:02x}")
        kind, width = sized
        n = self.length(width)
        if kind == "bin":
            return bytes(self.take(n))
        if kind == "str":
            return self.str(n)
        if kind == "array":
            return self.array(n)
        return self.map(n)

    def str(self, n: int) -> str:
        return str(self.take(n), "utf-8")

    def array(self, n: int) -> list:
        return [self.value() for _ in range(n)]

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            k = self.value()
            # msgpack.unpackb's strict_map_key default.
            if not isinstance(k, (str, bytes)):
                raise ValueError(
                    f"{type(k).__name__} is not allowed for map key when "
                    "strict_map_key=True")
            out[k] = self.value()
        return out


def unpackb(data) -> object:
    """``msgpack.unpackb(data, raw=False)``: one object, no trailing
    bytes."""
    r = _Reader(data)
    obj = r.value()
    if r.pos != len(r.buf):
        raise ValueError("msgpack: extra data after the object")
    return obj
