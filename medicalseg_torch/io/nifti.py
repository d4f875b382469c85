# Copyright 2026. Apache License 2.0.
"""Pure-numpy NIfTI-1 reader/writer.

The reference delegates NIfTI I/O to SimpleITK / nibabel (tools/prepare.py:
154-198, medicalseg/utils/utils.py:205-256); neither ships in this
environment, so the framework carries its own implementation of the
NIfTI-1 standard (348-byte header + optional gzip container).

Conventions (matching SimpleITK's GetArrayFromImage, which the reference's
.npy phase relies on):
  * voxel arrays are returned/accepted in z,y,x (slowest..fastest) order;
  * ``spacing`` / ``origin`` are x,y,z-ordered tuples;
  * ``direction`` is a row-major 9-tuple in ITK's LPS frame.
NIfTI itself is RAS; the converter negates the x/y rows when translating
the affine to/from the ITK convention.
"""

import gzip
import os
import struct

import numpy as np

# NIfTI-1 datatype codes -> numpy dtypes.
_DTYPES = {
    2: np.uint8,
    4: np.int16,
    8: np.int32,
    16: np.float32,
    64: np.float64,
    256: np.int8,
    512: np.uint16,
    768: np.uint32,
    1024: np.int64,
    1280: np.uint64,
}
_CODES = {np.dtype(v): k for k, v in _DTYPES.items()}

HEADER_SIZE = 348


class NiftiHeaderError(ValueError):
    pass


def _open(path, mode="rb", compresslevel=6):
    # Write level 6 (ITK/scanner default), not the gzip-module default 9:
    # level 9 triples compress time on smooth CT for ~2% size.
    if str(path).endswith(".gz"):
        if "w" in mode:
            return gzip.open(path, mode, compresslevel=compresslevel)
        return gzip.open(path, mode)
    return open(path, mode)


def _quaternion_to_matrix(b, c, d, qfac):
    a2 = 1.0 - (b * b + c * c + d * d)
    a = np.sqrt(max(a2, 0.0))
    m = np.array([
        [a * a + b * b - c * c - d * d, 2 * b * c - 2 * a * d,
         2 * b * d + 2 * a * c],
        [2 * b * c + 2 * a * d, a * a + c * c - b * b - d * d,
         2 * c * d - 2 * a * b],
        [2 * b * d - 2 * a * c, 2 * c * d + 2 * a * b,
         a * a + d * d - b * b - c * c],
    ])
    m[:, 2] *= qfac
    return m


def _read_bytes(path):
    """Whole-file read; .gz through the native one-shot inflate
    (``data_native.gzip_read_bytes``: libdeflate, 2-3x the gzip module),
    and through the gzip module only where that returns None (no gzip
    backend built, or a stream it calls corrupt: the gzip module then
    raises its own error)."""
    if str(path).endswith(".gz"):
        from .. import data_native
        buf = data_native.gzip_read_bytes(path)
        if buf is not None:
            return buf
        with gzip.open(path, "rb") as f:
            return f.read()
    with open(path, "rb") as f:
        return f.read()


def read_header(path):
    """Parse the 348-byte NIfTI-1 header into a dict."""
    with _open(path) as f:
        raw = f.read(HEADER_SIZE)
    return _parse_header(raw, path)


def _parse_header(raw, path):
    if len(raw) < HEADER_SIZE:
        raise NiftiHeaderError("Truncated NIfTI header in {}".format(path))

    sizeof_hdr = struct.unpack("<i", raw[0:4])[0]
    endian = "<"
    if sizeof_hdr != HEADER_SIZE:
        sizeof_hdr = struct.unpack(">i", raw[0:4])[0]
        if sizeof_hdr != HEADER_SIZE:
            raise NiftiHeaderError("Not a NIfTI-1 file: {}".format(path))
        endian = ">"

    def unpack(fmt, off, n=1):
        vals = struct.unpack_from(endian + fmt * n, raw, off)
        return vals[0] if n == 1 else vals

    hdr = {
        "endian": endian,
        "dim": unpack("h", 40, 8),
        "datatype": unpack("h", 70),
        "bitpix": unpack("h", 72),
        "pixdim": unpack("f", 76, 8),
        "vox_offset": unpack("f", 108),
        "scl_slope": unpack("f", 112),
        "scl_inter": unpack("f", 116),
        "qform_code": unpack("h", 252),
        "sform_code": unpack("h", 254),
        "quatern": unpack("f", 256, 3),
        "qoffset": unpack("f", 268, 3),
        "srow_x": unpack("f", 280, 4),
        "srow_y": unpack("f", 296, 4),
        "srow_z": unpack("f", 312, 4),
        "magic": bytes(raw[344:348]),  # raw may be a memoryview
    }
    if hdr["magic"][:3] not in (b"n+1", b"ni1"):
        raise NiftiHeaderError("Bad NIfTI magic in {}".format(path))
    return hdr


def _affine_from_header(hdr):
    """RAS affine, preferring sform > qform > pixdim (NIfTI-1 rules)."""
    if hdr["sform_code"] > 0:
        return np.array(
            [hdr["srow_x"], hdr["srow_y"], hdr["srow_z"], [0, 0, 0, 1.0]])
    affine = np.eye(4)
    pixdim = np.array(hdr["pixdim"][1:4])
    if hdr["qform_code"] > 0:
        qfac = -1.0 if hdr["pixdim"][0] < 0 else 1.0
        rot = _quaternion_to_matrix(*hdr["quatern"], qfac)
        affine[:3, :3] = rot * pixdim[None, :]
        affine[:3, 3] = hdr["qoffset"]
    else:
        affine[0, 0], affine[1, 1], affine[2, 2] = pixdim
    return affine


def _meta_from_affine(affine):
    """(spacing, origin, direction) in ITK/LPS convention from a RAS affine."""
    lps = affine.copy()
    lps[0] *= -1.0  # RAS -> LPS
    lps[1] *= -1.0
    rot = lps[:3, :3]
    spacing = np.linalg.norm(rot, axis=0)
    spacing = np.where(spacing == 0, 1.0, spacing)
    direction = rot / spacing[None, :]
    origin = lps[:3, 3]
    return (tuple(float(s) for s in spacing),
            tuple(float(o) for o in origin),
            tuple(float(d) for d in direction.reshape(-1)))


def read(path, dtype=None):
    """Read a .nii / .nii.gz volume.

    Returns:
        (data, meta): ``data`` is a numpy array in z,y,x order (t,z,y,x for
        4-D); ``meta`` is a dict with 'spacing', 'origin', 'direction'
        (ITK/LPS convention, x,y,z ordering) and 'affine' (RAS).
    """
    raw = _read_bytes(path)
    hdr = _parse_header(raw, path)
    ndim = hdr["dim"][0]
    shape_xyz = [max(1, d) for d in hdr["dim"][1:1 + max(ndim, 3)]]
    np_dtype = _DTYPES.get(hdr["datatype"])
    if np_dtype is None:
        raise NiftiHeaderError(
            "Unsupported NIfTI datatype code {}".format(hdr["datatype"]))

    count = int(np.prod(shape_xyz))
    off = int(hdr["vox_offset"])
    buf = raw[off:off + count * np.dtype(np_dtype).itemsize]
    data = np.frombuffer(buf, dtype=np_dtype, count=count)
    if hdr["endian"] == ">":
        data = data.byteswap().view(data.dtype.newbyteorder())
    # Stored Fortran-style: x fastest. Reshape to (..., z, y, x).
    data = data.reshape(shape_xyz[::-1])

    slope, inter = hdr["scl_slope"], hdr["scl_inter"]
    if slope not in (0.0, 1.0) or inter != 0.0:
        if slope == 0.0:
            slope = 1.0
        data = data.astype(np.float32) * slope + inter
    if dtype is not None:
        data = data.astype(dtype)

    affine = _affine_from_header(hdr)
    spacing, origin, direction = _meta_from_affine(affine)
    meta = {
        "spacing": spacing,
        "origin": origin,
        "direction": direction,
        "affine": affine,
        "ndim": int(ndim),
    }
    return np.ascontiguousarray(data), meta


def _affine_from_meta(spacing, origin, direction):
    direction = np.asarray(direction, dtype=np.float64).reshape(3, 3)
    spacing = np.asarray(spacing, dtype=np.float64)
    lps = np.eye(4)
    lps[:3, :3] = direction * spacing[None, :]
    lps[:3, 3] = np.asarray(origin, dtype=np.float64)
    ras = lps.copy()
    ras[0] *= -1.0
    ras[1] *= -1.0
    return ras


def write(path, data, spacing=(1, 1, 1), origin=(0, 0, 0),
          direction=(1, 0, 0, 0, 1, 0, 0, 0, 1)):
    """Write a z,y,x-ordered numpy array as .nii or .nii.gz.

    ``spacing``/``origin``/``direction`` use the ITK/LPS convention, so a
    volume round-trips through :func:`read` unchanged — which is what the
    reference's save_array + dataset.json geometry flow expects
    (medicalseg/utils/utils.py:205-256, core/val.py:138-154).
    """
    data = np.asarray(data)
    if data.dtype == np.bool_:
        data = data.astype(np.uint8)
    if data.dtype not in _CODES:
        data = data.astype(np.float32)
    if data.ndim not in (3, 4):
        raise ValueError("Expect 3-D or 4-D volume, got {}".format(
            data.shape))

    shape_xyz = data.shape[::-1]
    dim = [data.ndim] + list(shape_xyz) + [1] * (7 - data.ndim)
    affine = _affine_from_meta(spacing, origin, direction)

    hdr = bytearray(HEADER_SIZE)
    struct.pack_into("<i", hdr, 0, HEADER_SIZE)
    struct.pack_into("<8h", hdr, 40, *dim)
    struct.pack_into("<h", hdr, 70, _CODES[np.dtype(data.dtype)])
    struct.pack_into("<h", hdr, 72, data.dtype.itemsize * 8)
    pixdim = [1.0] + [float(s) for s in spacing] + [1.0] * (7 - 3)
    struct.pack_into("<8f", hdr, 76, *pixdim)
    struct.pack_into("<f", hdr, 108, 352.0)  # vox_offset
    struct.pack_into("<f", hdr, 112, 1.0)  # scl_slope
    struct.pack_into("<f", hdr, 116, 0.0)  # scl_inter
    struct.pack_into("<h", hdr, 252, 0)  # qform_code
    struct.pack_into("<h", hdr, 254, 1)  # sform_code: scanner anat
    struct.pack_into("<4f", hdr, 280, *affine[0])
    struct.pack_into("<4f", hdr, 296, *affine[1])
    struct.pack_into("<4f", hdr, 312, *affine[2])
    hdr[344:348] = b"n+1\x00"

    with _open(path, "wb") as f:
        f.write(bytes(hdr))
        f.write(b"\x00" * 4)  # extension flag
        f.write(np.ascontiguousarray(data).tobytes())
    return path
