"""The subset of MessagePack that checkpoint documents use, standard library
only, so a checkpoint needs no ``msgpack`` package where the port runs.

``packb(obj)`` writes ``None``, ``bool``, ``int`` (-2**63 .. 2**64 - 1),
``float`` (always float64), ``str``, ``bytes``-likes, ``list``/``tuple`` and
``dict`` in the smallest encoding of each value, the same bytes
``msgpack.packb(obj, use_bin_type=True)`` writes.  ``unpackb(raw)`` reads
what that call writes (and float32, which ``use_single_float`` writes);
str is decoded as UTF-8, arrays come back as lists, and ext/fixext values
are refused.
"""
from __future__ import annotations

import struct

_U8, _U16, _U32, _U64 = (struct.Struct(f) for f in (">B", ">H", ">I", ">Q"))
_I8, _I16, _I32, _I64 = (struct.Struct(f) for f in (">b", ">h", ">i", ">q"))
_F32, _F64 = struct.Struct(">f"), struct.Struct(">d")


def _sized(out: list, n: int, fix_base: int | None, fix_max: int, codes, what: str) -> None:
    """The header of a str/bin/array/map of length ``n``: a fix form below
    ``fix_max`` where the type has one, else the 8-, 16- or 32-bit form."""
    if fix_base is not None and n < fix_max:
        out.append(bytes((fix_base | n,)))
        return
    for code, fmt, limit in zip(codes, (_U8, _U16, _U32), (1 << 8, 1 << 16, 1 << 32)):
        if code is not None and n < limit:
            out.append(bytes((code,)) + fmt.pack(n))
            return
    raise ValueError(f"{what} of length {n} is too long for MessagePack")


def _int(out: list, v: int) -> None:
    if 0 <= v < 128 or -32 <= v < 0:
        out.append(_I8.pack(v) if v < 0 else bytes((v,)))
    elif v >= 0:
        for code, fmt, limit in ((0xCC, _U8, 1 << 8), (0xCD, _U16, 1 << 16),
                                 (0xCE, _U32, 1 << 32), (0xCF, _U64, 1 << 64)):
            if v < limit:
                out.append(bytes((code,)) + fmt.pack(v))
                return
        raise OverflowError("Integer value out of range")
    else:
        for code, fmt, limit in ((0xD0, _I8, 1 << 7), (0xD1, _I16, 1 << 15),
                                 (0xD2, _I32, 1 << 31), (0xD3, _I64, 1 << 63)):
            if v >= -limit:
                out.append(bytes((code,)) + fmt.pack(v))
                return
        raise OverflowError("Integer value out of range")


def _pack(out: list, obj) -> None:
    if obj is None:
        out.append(b"\xc0")
    elif obj is True or obj is False:
        out.append(b"\xc3" if obj else b"\xc2")
    elif isinstance(obj, int):
        _int(out, int(obj))
    elif isinstance(obj, float):
        out.append(b"\xcb" + _F64.pack(obj))
    elif isinstance(obj, str):
        raw = obj.encode("utf-8")
        _sized(out, len(raw), 0xA0, 32, (0xD9, 0xDA, 0xDB), "str")
        out.append(raw)
    elif isinstance(obj, (bytes, bytearray, memoryview)):
        raw = bytes(obj)
        _sized(out, len(raw), None, 0, (0xC4, 0xC5, 0xC6), "bin")
        out.append(raw)
    elif isinstance(obj, (list, tuple)):
        _sized(out, len(obj), 0x90, 16, (None, 0xDC, 0xDD), "array")
        for v in obj:
            _pack(out, v)
    elif isinstance(obj, dict):
        _sized(out, len(obj), 0x80, 16, (None, 0xDE, 0xDF), "map")
        for k, v in obj.items():
            _pack(out, k)
            _pack(out, v)
    else:
        raise TypeError(f"can not serialize {type(obj).__name__!r} object")


def packb(obj) -> bytes:
    out: list = []
    _pack(out, obj)
    return b"".join(out)


class _Reader:
    def __init__(self, raw):
        self.buf = memoryview(raw)
        self.pos = 0

    def take(self, n: int) -> memoryview:
        end = self.pos + n
        if end > len(self.buf):
            raise ValueError("truncated MessagePack data")
        view = self.buf[self.pos:end]
        self.pos = end
        return view

    def num(self, fmt: struct.Struct):
        return fmt.unpack(self.take(fmt.size))[0]

    def str(self, n: int) -> str:
        return str(self.take(n), "utf-8")

    def array(self, n: int) -> list:
        return [self.value() for _ in range(n)]

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            k = self.value()
            out[k] = self.value()
        return out

    def value(self):
        code = self.num(_U8)
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
        handler = _CODES.get(code)
        if handler is None:
            if 0xC7 <= code <= 0xC9 or 0xD4 <= code <= 0xD8:
                raise ValueError(f"MessagePack ext type (0x{code:02x}) is not supported "
                                 "in a checkpoint document")
            raise ValueError(f"invalid MessagePack type byte 0x{code:02x}")
        return handler(self)


_CODES = {
    0xC0: lambda r: None,
    0xC2: lambda r: False,
    0xC3: lambda r: True,
    0xC4: lambda r: bytes(r.take(r.num(_U8))),
    0xC5: lambda r: bytes(r.take(r.num(_U16))),
    0xC6: lambda r: bytes(r.take(r.num(_U32))),
    0xCA: lambda r: r.num(_F32),
    0xCB: lambda r: r.num(_F64),
    0xCC: lambda r: r.num(_U8),
    0xCD: lambda r: r.num(_U16),
    0xCE: lambda r: r.num(_U32),
    0xCF: lambda r: r.num(_U64),
    0xD0: lambda r: r.num(_I8),
    0xD1: lambda r: r.num(_I16),
    0xD2: lambda r: r.num(_I32),
    0xD3: lambda r: r.num(_I64),
    0xD9: lambda r: r.str(r.num(_U8)),
    0xDA: lambda r: r.str(r.num(_U16)),
    0xDB: lambda r: r.str(r.num(_U32)),
    0xDC: lambda r: r.array(r.num(_U16)),
    0xDD: lambda r: r.array(r.num(_U32)),
    0xDE: lambda r: r.map(r.num(_U16)),
    0xDF: lambda r: r.map(r.num(_U32)),
}


def unpackb(raw) -> object:
    reader = _Reader(raw)
    obj = reader.value()
    if reader.pos != len(reader.buf):
        raise ValueError(f"{len(reader.buf) - reader.pos} extra bytes after the document")
    return obj
