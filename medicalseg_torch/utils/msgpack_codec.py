# Copyright 2026. Apache License 2.0.
"""A small msgpack codec for checkpoints, with flax's array extension.

The JAX package writes its checkpoints with ``flax.serialization``:
msgpack maps with string keys whose leaves are numpy arrays, each an
extension of type 1 holding the msgpack array ``[shape, dtype name,
raw bytes]`` (type 3 holds a numpy scalar as ``[dtype name, raw bytes]``).
The port reads and writes that format itself, as the card's machine is
not known to have the ``msgpack`` package.

:func:`pack_chunks` (and :func:`packb`, the same bytes joined) encodes
None, booleans, integers (in msgpack's smallest form), floats, strings,
bytes, lists and tuples (as arrays), dicts and numpy arrays or scalars (as
type-1 extensions, C order); :func:`unpackb` decodes the whole format,
extensions of types 1 and 3 into numpy arrays, and raises on other
extensions.
"""

import struct

import numpy as np

_ND_ARRAY, _NP_SCALAR = 1, 3
# (code, struct format, low, high) of msgpack's integer forms, smallest
# first: the unsigned ones for values >= 0, the signed ones below
_INTS = ((0xCC, "B", 0, 1 << 8), (0xCD, "H", 0, 1 << 16),
         (0xCE, "I", 0, 1 << 32), (0xCF, "Q", 0, 1 << 64),
         (0xD0, "b", -(1 << 7), 0), (0xD1, "h", -(1 << 15), 0),
         (0xD2, "i", -(1 << 31), 0), (0xD3, "q", -(1 << 63), 0))


def _ext_header(out, code, n):
    """The header of an extension of type ``code`` holding ``n`` bytes."""
    fixed = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
    if n in fixed:
        out += bytes((fixed[n], code & 0xFF))
    elif n < 1 << 8:
        out += struct.pack(">BBb", 0xC7, n, code)
    elif n < 1 << 16:
        out += struct.pack(">BHb", 0xC8, n, code)
    else:
        out += struct.pack(">BIb", 0xC9, n, code)


def _bin_header(out, n):
    if n < 1 << 8:
        out += struct.pack(">BB", 0xC4, n)
    elif n < 1 << 16:
        out += struct.pack(">BH", 0xC5, n)
    else:
        out += struct.pack(">BI", 0xC6, n)


def _pack(obj, out, chunks):
    """Append ``obj``'s encoding to the bytearray ``out``; an array's data
    goes to the list ``chunks`` as a piece of its own (``out`` is moved
    there first and emptied), not copied."""
    if obj is None:
        out.append(0xC0)
    elif obj is True or obj is False:
        out.append(0xC3 if obj else 0xC2)
    elif isinstance(obj, (np.ndarray, np.generic)):
        # type 1: the msgpack array [shape, dtype name, raw bytes]
        arr = np.asarray(obj)
        raw = memoryview(np.ascontiguousarray(arr).reshape(-1).view(
            np.uint8))
        inner = bytearray([0x93])
        _pack(list(arr.shape), inner, chunks)  # no arrays: all in inner
        _pack(arr.dtype.name, inner, chunks)
        _bin_header(inner, raw.nbytes)
        _ext_header(out, _ND_ARRAY, len(inner) + raw.nbytes)
        out += inner
        chunks.append(bytes(out))
        del out[:]
        chunks.append(raw)
    elif isinstance(obj, int):  # the smallest form, as msgpack packs it
        if 0 <= obj < 0x80:
            out.append(obj)
        elif -32 <= obj < 0:
            out += struct.pack(">b", obj)
        else:
            for code, fmt, lo, hi in _INTS:
                if lo <= obj < hi:
                    out += struct.pack(">B" + fmt, code, obj)
                    break
            else:
                raise OverflowError("integer out of msgpack's range: "
                                    "{}".format(obj))
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
        _bin_header(out, len(data))
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
            _pack(item, out, chunks)
    elif isinstance(obj, dict):
        n = len(obj)
        if n < 16:
            out.append(0x80 | n)
        elif n < 1 << 16:
            out += struct.pack(">BH", 0xDE, n)
        else:
            out += struct.pack(">BI", 0xDF, n)
        for key, value in obj.items():
            _pack(key, out, chunks)
            _pack(value, out, chunks)
    else:
        raise TypeError("cannot pack {!r}".format(type(obj)))


def packb(obj) -> bytes:
    """``obj`` as msgpack bytes: :func:`pack_chunks` joined."""
    return b"".join(pack_chunks(obj))


def pack_chunks(obj) -> list:
    """``obj``'s msgpack bytes as a list of bytes-like pieces in order, the
    arrays' data as views of the (C-contiguous) arrays: written one after
    the other they make the file without a copy of the data in Python
    (a large ``write`` runs without the GIL)."""
    out, chunks = bytearray(), []
    _pack(obj, out, chunks)
    chunks.append(bytes(out))
    return chunks


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
