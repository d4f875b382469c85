# Copyright 2026. Apache License 2.0.
"""Pure-numpy MetaImage (.mha / .mhd+.raw) reader/writer.

Replaces the SimpleITK dependency the reference uses for Promise12-style
mhd datasets (tools/prepare.py:186-190). Supports uncompressed and
zlib-compressed element data.
"""

import os
import zlib

import numpy as np

_MET_TYPES = {
    "MET_CHAR": np.int8,
    "MET_UCHAR": np.uint8,
    "MET_SHORT": np.int16,
    "MET_USHORT": np.uint16,
    "MET_INT": np.int32,
    "MET_UINT": np.uint32,
    "MET_LONG": np.int64,
    "MET_ULONG": np.uint64,
    "MET_FLOAT": np.float32,
    "MET_DOUBLE": np.float64,
}
_MET_NAMES = {np.dtype(v): k for k, v in _MET_TYPES.items()}


def read(path):
    """Read .mha/.mhd. Returns (data_zyx, meta) like :mod:`..io.nifti`."""
    header = {}
    data_start = None
    with open(path, "rb") as f:
        while True:
            line = f.readline()
            if not line:
                break
            text = line.decode("latin1").strip()
            if "=" not in text:
                continue
            key, value = [s.strip() for s in text.split("=", 1)]
            header[key] = value
            if key == "ElementDataFile":
                data_start = f.tell()
                break

    ndims = int(header.get("NDims", 3))
    size_xyz = [int(s) for s in header["DimSize"].split()]
    dtype = _MET_TYPES[header["ElementType"]]
    spacing = [float(s) for s in header.get(
        "ElementSpacing", header.get("ElementSize", "1 1 1")).split()]
    offset = [float(s) for s in header.get(
        "Offset", header.get("Position", "0 0 0")).split()]
    direction = [float(s) for s in header.get(
        "TransformMatrix", "1 0 0 0 1 0 0 0 1").split()]
    compressed = header.get("CompressedData", "False").lower() == "true"
    byte_order_msb = header.get(
        "BinaryDataByteOrderMSB",
        header.get("ElementByteOrderMSB", "False")).lower() == "true"

    datafile = header["ElementDataFile"]
    count = int(np.prod(size_xyz))
    nbytes = count * np.dtype(dtype).itemsize
    if datafile == "LOCAL":
        with open(path, "rb") as f:
            f.seek(data_start)
            buf = f.read()
    else:
        datapath = os.path.join(os.path.dirname(path), datafile)
        with open(datapath, "rb") as f:
            buf = f.read()
    if compressed:
        buf = zlib.decompress(buf)
    data = np.frombuffer(buf[:nbytes], dtype=dtype)
    if byte_order_msb:
        data = data.byteswap()
    data = data.reshape(size_xyz[::-1])  # stored x-fastest -> z,y,x

    meta = {
        "spacing": tuple(spacing[:3]),
        "origin": tuple(offset[:3]),
        "direction": tuple(direction[:9]) if len(direction) >= 9 else
        (1, 0, 0, 0, 1, 0, 0, 0, 1),
        "ndim": ndims,
    }
    return np.ascontiguousarray(data), meta


def write(path, data, spacing=(1, 1, 1), origin=(0, 0, 0),
          direction=(1, 0, 0, 0, 1, 0, 0, 0, 1), compressed=False):
    """Write z,y,x-ordered data as .mha (local data) or .mhd+.raw."""
    data = np.asarray(data)
    if data.dtype not in _MET_NAMES:
        data = data.astype(np.float32)
    size_xyz = data.shape[::-1]

    is_mha = path.endswith(".mha")
    raw_name = None if is_mha else (
        os.path.basename(path)[:-4] + (".zraw" if compressed else ".raw"))

    lines = [
        "ObjectType = Image",
        "NDims = {}".format(data.ndim),
        "BinaryData = True",
        "BinaryDataByteOrderMSB = False",
        "CompressedData = {}".format("True" if compressed else "False"),
        "TransformMatrix = " + " ".join(str(v) for v in direction),
        "Offset = " + " ".join(str(v) for v in origin),
        "ElementSpacing = " + " ".join(str(v) for v in spacing),
        "DimSize = " + " ".join(str(v) for v in size_xyz),
        "ElementType = " + _MET_NAMES[np.dtype(data.dtype)],
        "ElementDataFile = " + ("LOCAL" if is_mha else raw_name),
    ]
    payload = np.ascontiguousarray(data).tobytes()
    if compressed:
        payload = zlib.compress(payload)
    header = ("\n".join(lines) + "\n").encode("latin1")
    if is_mha:
        with open(path, "wb") as f:
            f.write(header)
            f.write(payload)
    else:
        with open(path, "wb") as f:
            f.write(header)
        with open(os.path.join(os.path.dirname(path), raw_name), "wb") as f:
            f.write(payload)
    return path
