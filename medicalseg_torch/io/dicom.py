# Copyright 2026. Apache License 2.0.
"""Minimal pure-python DICOM reader (uncompressed transfer syntaxes).

Replaces the pydicom/SimpleITK series loading the reference uses for .dcm
datasets (tools/preprocess_utils/load_image.py:32-55). Parses explicit and
implicit VR little-endian data elements, extracts the pixel matrix plus the
geometry tags needed for volume assembly, and sorts series slices by
ImagePositionPatient (falling back to InstanceNumber, matching the
reference's ``load_slices`` ordering).
"""

import os
import struct

import numpy as np

# (group, element) tags we care about.
TAG_TRANSFER_SYNTAX = (0x0002, 0x0010)
TAG_INSTANCE_NUMBER = (0x0020, 0x0013)
TAG_POSITION = (0x0020, 0x0032)
TAG_ORIENTATION = (0x0020, 0x0037)
TAG_SLICE_THICKNESS = (0x0018, 0x0050)
TAG_SPACING_BETWEEN = (0x0018, 0x0088)
TAG_ROWS = (0x0028, 0x0010)
TAG_COLS = (0x0028, 0x0011)
TAG_PIXEL_SPACING = (0x0028, 0x0030)
TAG_BITS_ALLOCATED = (0x0028, 0x0100)
TAG_PIXEL_REPRESENTATION = (0x0028, 0x0103)
TAG_RESCALE_INTERCEPT = (0x0028, 0x1052)
TAG_RESCALE_SLOPE = (0x0028, 0x1053)
TAG_PIXEL_DATA = (0x7FE0, 0x0010)

_EXPLICIT_LONG_VRS = {b"OB", b"OW", b"OF", b"SQ", b"UT", b"UN", b"OD",
                      b"OL", b"UC", b"UR"}

_SUPPORTED_SYNTAXES = {
    "1.2.840.10008.1.2",       # implicit VR little endian
    "1.2.840.10008.1.2.1",     # explicit VR little endian
}


class DicomError(ValueError):
    pass


def _read_elements(buf, offset, explicit, stop_at_pixels=True):
    """Yield (tag, value_bytes) until the buffer ends."""
    n = len(buf)
    while offset + 8 <= n:
        group, elem = struct.unpack_from("<HH", buf, offset)
        tag = (group, elem)
        offset += 4
        if explicit and group != 0xFFFE:
            vr = buf[offset:offset + 2]
            if vr in _EXPLICIT_LONG_VRS:
                length = struct.unpack_from("<I", buf, offset + 4)[0]
                offset += 8
            else:
                length = struct.unpack_from("<H", buf, offset + 2)[0]
                offset += 4
            is_sq = vr == b"SQ"
        else:
            length = struct.unpack_from("<I", buf, offset)[0]
            offset += 4
            is_sq = False

        if length == 0xFFFFFFFF:
            # Undefined length (sequence / encapsulated): scan for the
            # matching SequenceDelimitationItem.
            end = buf.find(b"\xfe\xff\xdd\xe0", offset)
            if end < 0:
                return
            yield tag, None
            offset = end + 8
            continue

        value = buf[offset:offset + length]
        offset += length
        if is_sq:
            continue
        yield tag, value
        if stop_at_pixels and tag == TAG_PIXEL_DATA:
            return


def read(path):
    """Read one DICOM file. Returns (pixel_array_2d_float32, tags dict)."""
    with open(path, "rb") as f:
        buf = f.read()
    if buf[128:132] != b"DICM":
        # Some files omit the preamble; detect a plausible group-2 element.
        if buf[:4] == b"\x02\x00\x00\x00":
            buf = b" " * 132 + buf  # normalize offsets
        else:
            raise DicomError("Not a DICOM file: {}".format(path))

    # File meta info (group 0002) is always explicit VR little endian.
    syntax = "1.2.840.10008.1.2.1"
    offset = 132
    meta_end = offset
    for tag, value in _read_elements(buf, offset, explicit=True,
                                     stop_at_pixels=False):
        if tag[0] != 0x0002:
            break
        meta_end += 8 + len(value) if value is not None else 8
        if tag == TAG_TRANSFER_SYNTAX:
            syntax = value.decode("latin1").strip("\x00 ").strip()

    # Re-scan precisely: walk group-2 elements to find where they end.
    pos = 132
    while pos + 8 <= len(buf):
        group = struct.unpack_from("<H", buf, pos)[0]
        if group != 0x0002:
            break
        vr = buf[pos + 4:pos + 6]
        if vr in _EXPLICIT_LONG_VRS:
            length = struct.unpack_from("<I", buf, pos + 8)[0]
            pos += 12 + length
        else:
            length = struct.unpack_from("<H", buf, pos + 6)[0]
            pos += 8 + length

    if syntax not in _SUPPORTED_SYNTAXES:
        raise DicomError(
            "Unsupported (compressed?) transfer syntax {} in {}".format(
                syntax, path))
    explicit = syntax == "1.2.840.10008.1.2.1"

    tags = {}
    for tag, value in _read_elements(buf, pos, explicit=explicit):
        tags[tag] = value

    rows = struct.unpack("<H", tags[TAG_ROWS][:2])[0]
    cols = struct.unpack("<H", tags[TAG_COLS][:2])[0]
    bits = struct.unpack("<H", tags.get(TAG_BITS_ALLOCATED, b"\x10\x00")[:2])[0]
    signed = struct.unpack(
        "<H", tags.get(TAG_PIXEL_REPRESENTATION, b"\x00\x00")[:2])[0] == 1
    if bits == 16:
        dtype = np.int16 if signed else np.uint16
    elif bits == 8:
        dtype = np.int8 if signed else np.uint8
    else:
        raise DicomError("Unsupported BitsAllocated={}".format(bits))

    pixels = np.frombuffer(tags[TAG_PIXEL_DATA], dtype=dtype,
                           count=rows * cols).reshape(rows, cols)
    slope = float(_decode_ds(tags.get(TAG_RESCALE_SLOPE, b"1")) or 1.0)
    inter = float(_decode_ds(tags.get(TAG_RESCALE_INTERCEPT, b"0")) or 0.0)
    pixels = pixels.astype(np.float32) * slope + inter

    info = {
        "InstanceNumber": int(_decode_ds(
            tags.get(TAG_INSTANCE_NUMBER, b"0")) or 0),
        "ImagePositionPatient": _decode_ds_list(tags.get(TAG_POSITION)),
        "ImageOrientationPatient": _decode_ds_list(tags.get(TAG_ORIENTATION)),
        "PixelSpacing": _decode_ds_list(tags.get(TAG_PIXEL_SPACING)) or
        [1.0, 1.0],
        "SliceThickness": _decode_ds(tags.get(TAG_SLICE_THICKNESS)) or 1.0,
        "SpacingBetweenSlices": _decode_ds(tags.get(TAG_SPACING_BETWEEN)),
    }
    return pixels, info


def _decode_ds(value):
    if value is None:
        return None
    text = value.decode("latin1").strip("\x00 ").strip()
    if not text:
        return None
    return float(text.split("\\")[0])


def _decode_ds_list(value):
    if value is None:
        return None
    text = value.decode("latin1").strip("\x00 ").strip()
    if not text:
        return None
    return [float(v) for v in text.split("\\")]


def read_series(directory):
    """Assemble a z,y,x volume from all .dcm/.DCM/.IMA files in a directory.

    Slices are ordered by projecting ImagePositionPatient onto the slice
    normal; falls back to InstanceNumber when positions are missing.
    Returns (volume, meta) like :mod:`.nifti`.
    """
    files = sorted(
        os.path.join(directory, f) for f in os.listdir(directory)
        if f.lower().endswith((".dcm", ".ima")) or "." not in f)
    if not files:
        raise DicomError("No DICOM files found in {}".format(directory))

    slices = []
    for path in files:
        try:
            pixels, info = read(path)
        except DicomError:
            continue
        slices.append((pixels, info))
    if not slices:
        raise DicomError("No readable DICOM slices in {}".format(directory))

    orient = slices[0][1].get("ImageOrientationPatient")
    if orient and all(s[1].get("ImagePositionPatient") for s in slices):
        row = np.array(orient[:3])
        col = np.array(orient[3:])
        normal = np.cross(row, col)
        slices.sort(key=lambda s: float(
            np.dot(normal, s[1]["ImagePositionPatient"])))
    else:
        slices.sort(key=lambda s: s[1]["InstanceNumber"])

    volume = np.stack([s[0] for s in slices])
    info0 = slices[0][1]
    py, px = info0["PixelSpacing"][:2]
    if len(slices) > 1 and info0.get("ImagePositionPatient") and \
            slices[1][1].get("ImagePositionPatient"):
        dz = float(np.linalg.norm(
            np.array(slices[1][1]["ImagePositionPatient"]) -
            np.array(info0["ImagePositionPatient"])))
    else:
        dz = float(info0.get("SpacingBetweenSlices") or
                   info0["SliceThickness"])
    origin = info0.get("ImagePositionPatient") or [0.0, 0.0, 0.0]
    meta = {
        "spacing": (float(px), float(py), dz),
        "origin": tuple(float(v) for v in origin),
        "direction": (1, 0, 0, 0, 1, 0, 0, 0, 1),
        "ndim": 3,
    }
    return volume, meta
