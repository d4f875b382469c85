# Copyright 2026. Apache License 2.0.
"""Pure-numpy NRRD reader (subset).

Replaces the ``nrrd`` package the reference imports for .nrrd datasets
(tools/prepare.py:191-193). Supports raw / gzip encodings, little/big
endian, and the ``space directions`` / ``space origin`` geometry fields.
"""

import gzip
import io

import numpy as np

_NRRD_TYPES = {
    "signed char": np.int8, "int8": np.int8, "int8_t": np.int8,
    "uchar": np.uint8, "unsigned char": np.uint8, "uint8": np.uint8,
    "uint8_t": np.uint8,
    "short": np.int16, "short int": np.int16, "signed short": np.int16,
    "int16": np.int16, "int16_t": np.int16,
    "ushort": np.uint16, "unsigned short": np.uint16, "uint16": np.uint16,
    "uint16_t": np.uint16,
    "int": np.int32, "signed int": np.int32, "int32": np.int32,
    "int32_t": np.int32,
    "uint": np.uint32, "unsigned int": np.uint32, "uint32": np.uint32,
    "uint32_t": np.uint32,
    "longlong": np.int64, "int64": np.int64, "int64_t": np.int64,
    "ulonglong": np.uint64, "uint64": np.uint64, "uint64_t": np.uint64,
    "float": np.float32,
    "double": np.float64,
}


def _parse_vector(text):
    text = text.strip()
    if text == "none":
        return None
    return [float(v) for v in text.strip("()").split(",")]


def read(path):
    """Read a .nrrd file. Returns (data_zyx, meta)."""
    fields = {}
    with open(path, "rb") as f:
        magic = f.readline()
        if not magic.startswith(b"NRRD"):
            raise ValueError("Not a NRRD file: {}".format(path))
        while True:
            line = f.readline()
            if line in (b"\n", b"\r\n", b""):
                break
            text = line.decode("latin1").strip()
            if text.startswith("#"):
                continue
            sep = ":=" if ":=" in text else ":"
            key, value = text.split(sep, 1)
            fields[key.strip().lower()] = value.strip()
        payload = f.read()

    sizes = [int(s) for s in fields["sizes"].split()]
    dtype = np.dtype(_NRRD_TYPES[fields["type"]])
    if fields.get("endian", "little") == "big":
        dtype = dtype.newbyteorder(">")
    encoding = fields.get("encoding", "raw")
    if encoding in ("gzip", "gz"):
        payload = gzip.GzipFile(fileobj=io.BytesIO(payload)).read()
    elif encoding not in ("raw",):
        raise ValueError("Unsupported NRRD encoding: {}".format(encoding))

    count = int(np.prod(sizes))
    data = np.frombuffer(payload, dtype=dtype, count=count)
    data = data.astype(dtype.newbyteorder("="))
    data = data.reshape(sizes[::-1])  # NRRD lists fastest axis first

    spacing, direction = (1.0, 1.0, 1.0), (1, 0, 0, 0, 1, 0, 0, 0, 1)
    if "space directions" in fields:
        vecs = [_parse_vector(v)
                for v in fields["space directions"].split(") ")]
        vecs = [v for v in vecs if v is not None]
        if len(vecs) == 3:
            mat = np.array(vecs).T  # columns are axis vectors
            sp = np.linalg.norm(mat, axis=0)
            sp = np.where(sp == 0, 1.0, sp)
            spacing = tuple(float(s) for s in sp)
            direction = tuple(float(d) for d in (mat / sp[None, :]).reshape(-1))
    origin = (0.0, 0.0, 0.0)
    if "space origin" in fields:
        vec = _parse_vector(fields["space origin"])
        if vec:
            origin = tuple(vec)

    meta = {
        "spacing": spacing,
        "origin": origin,
        "direction": direction,
        "ndim": len(sizes),
    }
    return np.ascontiguousarray(data), meta


def write(path, data, spacing=(1, 1, 1), origin=(0, 0, 0)):
    """Write z,y,x-ordered data as a gzip-encoded NRRD."""
    data = np.asarray(data)
    names = {np.dtype(np.int8): "int8", np.dtype(np.uint8): "uint8",
             np.dtype(np.int16): "int16", np.dtype(np.uint16): "uint16",
             np.dtype(np.int32): "int32", np.dtype(np.uint32): "uint32",
             np.dtype(np.int64): "int64", np.dtype(np.float32): "float",
             np.dtype(np.float64): "double"}
    if data.dtype not in names:
        data = data.astype(np.float32)
    sizes = " ".join(str(s) for s in data.shape[::-1])
    dirs = " ".join("({},{},{})".format(*(np.eye(3)[i] * spacing[i]))
                    for i in range(3))
    header = ("NRRD0004\n"
              "type: {}\n"
              "dimension: {}\n"
              "space: left-posterior-superior\n"
              "sizes: {}\n"
              "space directions: {}\n"
              "space origin: ({},{},{})\n"
              "kinds: domain domain domain\n"
              "endian: little\n"
              "encoding: gzip\n\n").format(
                  names[np.dtype(data.dtype)], data.ndim, sizes, dirs,
                  *origin)
    with open(path, "wb") as f:
        f.write(header.encode("latin1"))
        f.write(gzip.compress(np.ascontiguousarray(data).tobytes()))
    return path
