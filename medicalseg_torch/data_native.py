# Copyright 2026. Apache License 2.0.
"""ctypes binding of the native volume reader (``csrc/medloader.cpp``).

Counterpart of ``medicalseg_tpu/data_native.py``, with its names and
signatures, over the port's own copy of the C++ source. The library is
built with ``g++`` at first use (:func:`medicalseg_torch.ops._build.
build_host`: libdeflate, then zlib, then no gzip backend) into
``build/torch_kernels/``; nothing is built at import. Where no rung
builds, :func:`get_lib` raises with the compiler's output: there is no
numpy fallback.

Where volumes come out as tensors (the fused HU-window + resize), they
are CPU ``torch`` tensors; bf16 is written into a uint16 buffer and
viewed as ``torch.bfloat16``. The volume loads write into a numpy array
or into a caller's contiguous CPU tensor (pinned or not) through its
``data_ptr()``.
"""

import ctypes
import functools
import os
import threading

import numpy as np
import torch

# out_kind codes of hu_resize_run in csrc/medloader.cpp: (code, numpy
# buffer dtype, tensor dtype)
_OUT_KINDS = {
    "float32": (0, np.float32, torch.float32),
    "bfloat16": (1, np.uint16, torch.bfloat16),
    "uint8": (2, np.uint8, torch.uint8),
}
# volume loads: numpy dtype -> (entry point, tensor dtype)
_LOADS = {
    np.dtype(np.float32): ("ml_load_f32", torch.float32),
    np.dtype(np.int32): ("ml_load_i32", torch.int32),
    np.dtype(np.uint8): ("ml_load_u8", torch.uint8),
}
_TORCH_TO_NP = {torch.float32: np.float32, torch.int32: np.int32,
                torch.uint8: np.uint8}


def _as_tensor(out, out_dtype):
    """The filled numpy buffer as a CPU tensor (no copy)."""
    t = torch.from_numpy(out)
    return t.view(torch.bfloat16) if out_dtype == "bfloat16" else t


def _out_buffer(size, out_dtype):
    od, oh, ow = (int(s) for s in size)
    if min(od, oh, ow) < 1:
        raise ValueError("size must be positive, got {}".format(size))
    kind, np_dtype, _ = _OUT_KINDS[out_dtype]
    return np.empty((od, oh, ow), np_dtype), kind


def hu_resize_array(vol, size, hu_min=-1200.0, hu_max=600.0,
                    hu_nan=-2000.0, out_dtype="float32", window=True,
                    threads=0):
    """Fused HU window + trilinear resize of an in-memory volume (float32
    or int16 [D, H, W]; other dtypes are cast to float32 first) to
    ``size`` (d, h, w) on the host: the math of ``ops.hu_resize.
    hu_norm_resize`` (window to [0, 255], then the endpoint-aligned order-1
    zoom). ``out_dtype`` 'float32' | 'bfloat16' | 'uint8' (rounded);
    ``window=False`` zooms the raw values; ``threads=0`` uses one thread a
    core. Returns a CPU tensor."""
    lib = get_lib()
    vol = np.ascontiguousarray(vol)
    if vol.ndim != 3:
        raise ValueError("expected [D, H, W], got {}".format(vol.shape))
    if vol.dtype not in (np.float32, np.int16):
        vol = vol.astype(np.float32)
    out, kind = _out_buffer(size, out_dtype)
    fn = (lib.ml_hu_resize_f32 if vol.dtype == np.float32
          else lib.ml_hu_resize_i16)
    got = fn(vol.ctypes.data_as(ctypes.c_void_p), *vol.shape,
             out.ctypes.data_as(ctypes.c_void_p), *out.shape, hu_min,
             hu_max, hu_nan, kind, 1 if window else 0, int(threads))
    if got != out.size:
        raise RuntimeError("ml_hu_resize of a {} volume failed with code "
                           "{}".format(vol.shape, got))
    return _as_tensor(out, out_dtype)


def gzip_read_bytes(path):
    """Inflate a whole gzip file (multi-member streams too) through the
    native backend in one call (libdeflate: 2-3x the gzip module on CT
    payloads). Returns a bytes-like memoryview of the decode buffer
    (which it keeps alive), or None where the caller should use the gzip
    module: no gzip backend was built, or the native inflate calls the
    stream corrupt or not gzip (the gzip module then raises its own
    error). Raises OSError when the file cannot be read."""
    lib = get_lib()
    size = os.path.getsize(path)  # raises for a missing file
    pb = os.fsencode(path)
    hint = lib.ml_gzip_isize(pb)
    if hint < 0:
        raise OSError("cannot read {}".format(path))
    # ISIZE is exact for the single-member streams scanners write; a
    # multi-member file may need more, so grow on -2 (insufficient space)
    cap = max(int(hint), size, 1 << 20)
    while True:
        out = np.empty(cap, np.uint8)
        got = lib.ml_gzip_read(pb, out.ctypes.data_as(ctypes.c_void_p), cap)
        if got >= 0:
            # a grown buffer far larger than the payload is copied to its
            # size rather than kept alive for the caller's lifetime
            if got * 2 < cap:
                return bytes(memoryview(out)[:got])
            return memoryview(out)[:got]
        if got in (-3, -4):  # no backend / corrupt: the gzip module's turn
            return None
        if got != -2:
            raise OSError("cannot read {} (code {})".format(path, got))
        cap *= 4  # deflate's ratio is at most 1032:1, so this ends


def load_nii_hu_resize(path, size, hu_min=-1200.0, hu_max=600.0,
                       hu_nan=-2000.0, out_dtype="bfloat16", window=True,
                       threads=0):
    """One-shot ``.nii`` / ``.nii.gz`` ingest on the host: read, inflate,
    parse the NIfTI-1 header and run :func:`hu_resize_array`'s fused
    window + resize on the voxels, with no intermediate volume. Handles
    little-endian int16 / float32 voxels without scaling (CT's formats);
    raises RuntimeError for anything else, or a file it cannot read.
    Returns a CPU tensor of ``size``."""
    lib = get_lib()
    out, kind = _out_buffer(size, out_dtype)
    dims = (ctypes.c_longlong * 3)()
    got = lib.ml_load_nii_hu_resize(
        os.fsencode(path), out.ctypes.data_as(ctypes.c_void_p), *out.shape,
        hu_min, hu_max, hu_nan, kind, 1 if window else 0, int(threads), dims)
    if got != out.size:
        raise RuntimeError("ml_load_nii_hu_resize({}) failed with code "
                           "{}".format(path, got))
    return _as_tensor(out, out_dtype)


def _declare(lib):
    """argtypes and restype of every entry point."""
    c_int, c_ll, c_float = ctypes.c_int, ctypes.c_longlong, ctypes.c_float
    vp, cp = ctypes.c_void_p, ctypes.c_char_p
    resize = [vp, c_int, c_int, c_int, vp, c_int, c_int, c_int, c_float,
              c_float, c_float, c_int, c_int, c_int]
    table = {
        "ml_create": (vp, [ctypes.POINTER(cp), c_int, c_int, c_ll]),
        "ml_destroy": (None, [vp]),
        "ml_prefetch": (None, [vp, ctypes.POINTER(c_int), c_int]),
        "ml_shape": (c_int, [vp, c_int, ctypes.POINTER(c_ll)]),
        "ml_load_f32": (c_ll, [vp, c_int, vp, c_ll]),
        "ml_load_i32": (c_ll, [vp, c_int, vp, c_ll]),
        "ml_load_u8": (c_ll, [vp, c_int, vp, c_ll]),
        "ml_load_hu_resize": (c_ll, [vp, c_int, vp, c_int, c_int, c_int,
                                     c_float, c_float, c_float, c_int,
                                     c_int, c_int]),
        "ml_hu_resize_f32": (c_ll, resize),
        "ml_hu_resize_i16": (c_ll, resize),
        "ml_gzip_isize": (c_ll, [cp]),
        "ml_gzip_read": (c_ll, [cp, vp, c_ll]),
        "ml_load_nii_hu_resize": (c_ll, [cp, vp, c_int, c_int, c_int,
                                         c_float, c_float, c_float, c_int,
                                         c_int, c_int,
                                         ctypes.POINTER(c_ll)]),
    }
    for name, (restype, argtypes) in table.items():
        fn = getattr(lib, name)
        fn.restype, fn.argtypes = restype, argtypes
    return lib


@functools.lru_cache(maxsize=None)
def _loaded():
    from .ops import _build
    path, rung = _build.build_host("medloader")
    return _declare(ctypes.CDLL(str(path))), rung


def get_lib():
    """The native library, built at first use. Raises RuntimeError with
    the compiler's output when no rung of the build ladder builds."""
    return _loaded()[0]


def backend():
    """The gzip backend the library was built with: 'libdeflate', 'zlib'
    or 'none' (builds it if need be)."""
    return _loaded()[1].split("-")[0]


def _address(out, np_dtype, count):
    """``out``'s data pointer after checking that it is a C-contiguous
    CPU buffer of ``count`` elements of ``np_dtype`` (numpy array or
    tensor) that the library may write."""
    if isinstance(out, torch.Tensor):
        ok = (out.device.type == "cpu" and out.is_contiguous() and
              out.dtype == _LOADS[np.dtype(np_dtype)][1] and
              out.numel() == count)
        if not ok:
            raise ValueError(
                "out must be a contiguous CPU {} tensor of {} elements, got "
                "{} {} on {}".format(_LOADS[np.dtype(np_dtype)][1], count,
                                     out.dtype, tuple(out.shape), out.device))
        return out.data_ptr()
    if not (isinstance(out, np.ndarray) and out.dtype == np_dtype and
            out.flags.c_contiguous and out.flags.writeable and
            out.size == count):
        raise ValueError("out must be a writeable C-contiguous {} array of "
                         "{} elements".format(np.dtype(np_dtype), count))
    return out.ctypes.data


class NativeVolumeLoader:
    """Threaded ``.npy`` volume reader with an LRU byte cache and
    asynchronous prefetch (a C++ thread pool; ``.npy`` v1 / v2, C order,
    ``<f4 <i4 <i2 |u1 <f8 <i8``; a Fortran-order file raises IOError).

    Args:
        paths: the ``.npy`` files, addressed by their index.
        threads: reader threads.
        cache_bytes: budget of the decoded-volume cache.

    Calls from several threads are serialized. :meth:`close` (or leaving a
    ``with`` block) frees the C++ side once no call is in flight; a call
    after it raises ValueError.
    """

    def __init__(self, paths, threads=4, cache_bytes=2 << 30):
        self._handle = None
        self._lock = threading.Lock()
        self._lib = get_lib()
        self._paths = [os.fspath(p) for p in paths]
        arr = (ctypes.c_char_p * len(self._paths))(
            *[os.fsencode(p) for p in self._paths])
        self._handle = self._lib.ml_create(arr, len(self._paths),
                                           int(threads), int(cache_bytes))
        if not self._handle:
            raise RuntimeError("ml_create failed")

    def __len__(self):
        return len(self._paths)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def close(self):
        """Join the reader threads and free the cache (idempotent)."""
        with self._lock:
            if self._handle:
                self._lib.ml_destroy(self._handle)
                self._handle = None

    def __del__(self):
        if getattr(self, "_handle", None):
            self.close()

    def _call(self, name, *args):
        with self._lock:
            if not self._handle:
                raise ValueError("NativeVolumeLoader is closed")
            return getattr(self._lib, name)(self._handle, *args)

    def _index(self, idx):
        idx = int(idx)
        if not 0 <= idx < len(self._paths):
            raise IndexError("volume {} of {}".format(idx, len(self._paths)))
        return idx

    def prefetch(self, indices):
        """Queue ``indices`` for the reader threads (returns at once)."""
        idxs = [self._index(i) for i in indices]
        self._call("ml_prefetch", (ctypes.c_int * len(idxs))(*idxs),
                   len(idxs))

    def shape(self, idx):
        """The volume's shape (reads it into the cache)."""
        dims = (ctypes.c_longlong * 8)()
        nd = self._call("ml_shape", self._index(idx), dims)
        if nd < 0:
            raise IOError("failed to read {}".format(self._paths[idx]))
        return tuple(int(dims[i]) for i in range(nd))

    def _load(self, np_dtype, idx, out):
        shape = self.shape(idx)
        n = int(np.prod(shape))
        if out is None:
            out = np.empty(shape, np_dtype)
        got = self._call(_LOADS[np.dtype(np_dtype)][0], int(idx),
                         _address(out, np_dtype, n), n)
        if got != n:
            raise IOError("short read on {}".format(self._paths[idx]))
        return out

    def load_f32(self, idx, out=None):
        """Volume ``idx`` cast to float32, into ``out`` (a numpy array or
        CPU tensor of its size) or a new array."""
        return self._load(np.float32, idx, out)

    def load_i32(self, idx, out=None):
        """Volume ``idx`` cast to int32 (C casts: floats truncate)."""
        return self._load(np.int32, idx, out)

    def load_u8(self, idx, out=None):
        """Volume ``idx`` cast to uint8, clamped to [0, 255] (labels)."""
        return self._load(np.uint8, idx, out)

    def load_batch(self, indices, dtype=np.float32, out=None):
        """Volumes ``indices`` as one contiguous [N, ...] batch of
        ``dtype`` (float32, int32 or uint8, numpy or torch), read by the
        thread pool (prefetched together) into ``out`` (a numpy array or
        a contiguous CPU tensor, pinned or not) or a new array. Every
        volume must have one shape: ValueError otherwise."""
        np_dtype = np.dtype(_TORCH_TO_NP.get(dtype, dtype))
        if np_dtype not in _LOADS:
            raise ValueError("dtype must be float32, int32 or uint8, got "
                             "{}".format(dtype))
        indices = [self._index(i) for i in indices]
        self.prefetch(indices)
        shape = self.shape(indices[0])
        if out is None:
            out = np.empty((len(indices),) + shape, np_dtype)
        _address(out, np_dtype, len(indices) * int(np.prod(shape)))
        for i, idx in enumerate(indices):
            got = self.shape(idx)
            if got != shape:
                raise ValueError("a batch needs one volume shape; {} is {}, "
                                 "{} is {}".format(self._paths[indices[0]],
                                                   shape, self._paths[idx],
                                                   got))
            self._load(np_dtype, idx, out[i])
        return out

    def load_hu_resize(self, idx, size, hu_min=-1200.0, hu_max=600.0,
                       hu_nan=-2000.0, out_dtype="float32", window=True,
                       threads=0, out=None):
        """:func:`hu_resize_array` on volume ``idx`` (float32 or int16)
        from the cache, so only ``size``-shaped bytes leave the host.
        ``out``: a C-contiguous numpy buffer of ``size`` (uint16 for bf16)
        or None. Returns a CPU tensor."""
        buf, kind = _out_buffer(size, out_dtype)
        if out is None:
            out = buf
        elif not (isinstance(out, np.ndarray) and out.dtype == buf.dtype and
                  out.shape == buf.shape and out.flags.c_contiguous and
                  out.flags.writeable):
            raise ValueError("out must be a writeable C-contiguous {} array "
                             "of shape {}".format(buf.dtype, buf.shape))
        got = self._call("ml_load_hu_resize", self._index(idx),
                         out.ctypes.data_as(ctypes.c_void_p), *out.shape,
                         hu_min, hu_max, hu_nan, kind, 1 if window else 0,
                         int(threads))
        if got != out.size:
            raise IOError("hu_resize failed on {}".format(self._paths[idx]))
        return _as_tensor(out, out_dtype)
