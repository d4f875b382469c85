# Copyright 2026. Apache License 2.0.
"""A small msgpack codec for checkpoints, with flax's array extension.

The JAX package writes its checkpoints with ``flax.serialization``:
msgpack maps with string keys whose leaves are numpy arrays, each an
extension of type 1 holding the msgpack array ``[shape, dtype name,
raw bytes]`` (type 3 holds a numpy scalar as ``[dtype name, raw bytes]``).
The port reads and writes that format itself, as the card's machine is
not known to have the ``msgpack`` package.

:func:`packb` encodes None, booleans, integers, floats, strings, bytes,
lists and tuples (as arrays), dicts and numpy arrays or scalars (as type-1
extensions, C order); :func:`unpackb` decodes the whole format, extensions
of types 1 and 3 into numpy arrays, and raises on other extensions.
"""

import struct

import numpy as np

_ND_ARRAY, _NP_SCALAR = 1, 3


def _pack_ext(out, code, data):
    n = len(data)
    fixed = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
    if n in fixed:
        out += bytes((fixed[n], code & 0xFF))
    elif n < 1 << 8:
        out += struct.pack(">BBb", 0xC7, n, code)
    elif n < 1 << 16:
        out += struct.pack(">BHb", 0xC8, n, code)
    else:
        out += struct.pack(">BIb", 0xC9, n, code)
    out += data


def _pack(obj, out):
    if obj is None:
        out.append(0xC0)
    elif obj is True or obj is False:
        out.append(0xC3 if obj else 0xC2)
    elif isinstance(obj, (np.ndarray, np.generic)):
        arr = np.asarray(obj)
        payload = bytearray()
        _pack([list(arr.shape), arr.dtype.name,
               np.ascontiguousarray(arr).tobytes()], payload)
        _pack_ext(out, _ND_ARRAY, bytes(payload))
    elif isinstance(obj, int):
        if 0 <= obj < 0x80:
            out.append(obj)
        elif -32 <= obj < 0:
            out += struct.pack(">b", obj)
        elif 0 <= obj < 1 << 64:
            out += struct.pack(">BQ", 0xCF, obj)
        elif -(1 << 63) <= obj < 0:
            out += struct.pack(">Bq", 0xD3, obj)
        else:
            raise OverflowError("integer out of msgpack's range: {}".format(
                obj))
    elif isinstance(obj, float):
        out += struct.pack(">Bd", 0xCB, obj)
    elif isinstance(obj, str):
        data = obj.encode("utf-8")
        n = len(data)
        if n < 32:
            out.append(0xA0 | n)
        elif n < 1 << 8:
            out += struct.pack(">BB", 0xD9, n)
        elif n < 1 << 16:
            out += struct.pack(">BH", 0xDA, n)
        else:
            out += struct.pack(">BI", 0xDB, n)
        out += data
    elif isinstance(obj, (bytes, bytearray, memoryview)):
        data = bytes(obj)
        n = len(data)
        if n < 1 << 8:
            out += struct.pack(">BB", 0xC4, n)
        elif n < 1 << 16:
            out += struct.pack(">BH", 0xC5, n)
        else:
            out += struct.pack(">BI", 0xC6, n)
        out += data
    elif isinstance(obj, (list, tuple)):
        n = len(obj)
        if n < 16:
            out.append(0x90 | n)
        elif n < 1 << 16:
            out += struct.pack(">BH", 0xDC, n)
        else:
            out += struct.pack(">BI", 0xDD, n)
        for item in obj:
            _pack(item, out)
    elif isinstance(obj, dict):
        n = len(obj)
        if n < 16:
            out.append(0x80 | n)
        elif n < 1 << 16:
            out += struct.pack(">BH", 0xDE, n)
        else:
            out += struct.pack(">BI", 0xDF, n)
        for key, value in obj.items():
            _pack(key, out)
            _pack(value, out)
    else:
        raise TypeError("cannot pack {!r}".format(type(obj)))


def packb(obj) -> bytes:
    """``obj`` as msgpack bytes."""
    out = bytearray()
    _pack(obj, out)
    return bytes(out)


class _Reader:
    def __init__(self, data):
        self.data = memoryview(data)
        self.pos = 0

    def take(self, n):
        if self.pos + n > len(self.data):
            raise ValueError("truncated msgpack data")
        chunk = self.data[self.pos:self.pos + n]
        self.pos += n
        return chunk

    def unpack(self, fmt):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]


def _ext(code, data):
    if code == _ND_ARRAY:
        shape, dtype, raw = unpackb(data)
        return np.frombuffer(raw, dtype=np.dtype(dtype)).reshape(
            shape).copy()
    if code == _NP_SCALAR:
        dtype, raw = unpackb(data)
        return np.frombuffer(raw, dtype=np.dtype(dtype))[0]
    raise ValueError("unsupported msgpack extension type {}".format(code))


_FIXED = {0xCA: ">f", 0xCB: ">d", 0xCC: ">B", 0xCD: ">H", 0xCE: ">I",
          0xCF: ">Q", 0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}
_LENGTHS = {0xC4: ">B", 0xC5: ">H", 0xC6: ">I", 0xD9: ">B", 0xDA: ">H",
            0xDB: ">I", 0xDC: ">H", 0xDD: ">I", 0xDE: ">H", 0xDF: ">I",
            0xC7: ">B", 0xC8: ">H", 0xC9: ">I"}


def _read(r):
    b = r.unpack(">B")
    if b < 0x80:
        return b
    if b >= 0xE0:
        return b - 0x100
    if b & 0xF0 == 0x80:
        return _read_map(r, b & 0x0F)
    if b & 0xF0 == 0x90:
        return [_read(r) for _ in range(b & 0x0F)]
    if b & 0xE0 == 0xA0:
        return bytes(r.take(b & 0x1F)).decode("utf-8")
    if b == 0xC0:
        return None
    if b in (0xC2, 0xC3):
        return b == 0xC3
    if b in _FIXED:
        return r.unpack(_FIXED[b])
    if 0xD4 <= b <= 0xD8:
        code = r.unpack(">b")
        return _ext(code, bytes(r.take(1 << (b - 0xD4))))
    if b in _LENGTHS:
        n = r.unpack(_LENGTHS[b])
        if b in (0xC4, 0xC5, 0xC6):
            return bytes(r.take(n))
        if b in (0xD9, 0xDA, 0xDB):
            return bytes(r.take(n)).decode("utf-8")
        if b in (0xDC, 0xDD):
            return [_read(r) for _ in range(n)]
        if b in (0xDE, 0xDF):
            return _read_map(r, n)
        code = r.unpack(">b")
        return _ext(code, bytes(r.take(n)))
    raise ValueError("invalid msgpack byte 0x{:02x}".format(b))


def _read_map(r, n):
    out = {}
    for _ in range(n):
        key = _read(r)
        out[key] = _read(r)
    return out


def unpackb(data):
    """The object encoded by msgpack ``data``."""
    r = _Reader(data)
    obj = _read(r)
    if r.pos != len(r.data):
        raise ValueError("extra bytes after the msgpack object")
    return obj
