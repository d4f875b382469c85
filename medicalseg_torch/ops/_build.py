# Copyright 2026. Apache License 2.0.
"""Build the native sources under ``medicalseg_torch/csrc`` and load them.

Each ``csrc/<name>.cu`` has a plain C interface. At first use it is
compiled with ``nvcc`` for ``sm_90a`` into ``build/torch_kernels/`` at the
root of the checkout (listed in ``.gitignore``) and loaded with
:mod:`ctypes`. The library's file name carries a hash of its source and
flags, so an edited source is rebuilt and a stale library is never loaded.
Nothing is compiled when a module is imported: the CPU tests import every
module on a machine with no ``nvcc``.

The host source ``csrc/medloader.cpp`` (the native volume reader,
:mod:`medicalseg_torch.data_native`) is built the same way with ``g++``
(:func:`build_host`), down a ladder of gzip backends, fastest first:
libdeflate with ``-march=native``, libdeflate, zlib, none. Its library's
name carries the rung that built and a hash of the source, the flags, the
compiler's ``--version`` and, for ``-march=native``, the target options
the compiler resolves it to on this machine.
"""

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Dict, Iterable, Tuple

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
SOURCES = ("conv5", "conv5_wg", "conv5_stem", "conv5_stem_wgrad",
           "conv5_tf32", "conv5_stem_tf32", "conv5_stem_wgrad_tf32",
           "conv5_wgrad", "conv5_wgrad_tma", "conv5_wgrad_tf32", "pin",
           "hu_resize")
GXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC", "-pthread")
# (rung, compile flags, link flags): the host build's gzip backends,
# fastest first (libdeflate inflates a whole file at once, 2-3x zlib);
# "none" builds every entry point but the inflate, which then reports -3
HOST_LADDER = (
    ("libdeflate-native", ("-march=native", "-DML_WITH_DEFLATE"),
     ("-ldeflate",)),
    ("libdeflate", ("-DML_WITH_DEFLATE",), ("-ldeflate",)),
    ("zlib", ("-DML_WITH_ZLIB",), ("-lz",)),
    ("none", (), ()),
)


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME")
    for cand in ((Path(home) / "bin" / "nvcc") if home else None,
                 shutil.which("nvcc"), Path("/usr/local/cuda/bin/nvcc")):
        if cand and Path(cand).is_file():
            return str(cand)
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH "
                       "to build the CUDA kernels")


def _library_path(name: str) -> Path:
    src = CSRC / (name + ".cu")
    digest = hashlib.sha256(src.read_bytes() +
                            " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / "lib{}-{}.so".format(name, digest)


def build(names: Iterable[str] = SOURCES) -> Dict[str, Path]:
    """Compile the named sources that are not built yet, one ``nvcc`` each,
    all started together. Returns {name: library path}; raises with the
    compiler's output when a build fails. ``nvcc``'s own messages
    (``-Xptxas -v``: registers and shared memory of each kernel) are kept
    beside each library as ``<library>.log``."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    paths = {n: _library_path(n) for n in names}
    jobs = []
    for name, path in paths.items():
        if path.exists():
            continue
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, str(CSRC / (name + ".cu"))]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        jobs.append((name, path, tmp, proc))
    failed = []
    for name, path, tmp, proc in jobs:
        out, _ = proc.communicate()
        path.with_suffix(".log").write_text(out)
        if proc.returncode == 0:
            os.replace(tmp, path)  # atomic: a reader never sees half a file
        else:
            os.unlink(tmp)
            failed.append("{} (nvcc exit {}):\n{}".format(
                name, proc.returncode, out))
    if failed:
        raise RuntimeError("CUDA build failed: " + "\n".join(failed))
    return paths


@functools.lru_cache(maxsize=None)
def library(name: str) -> ctypes.CDLL:
    """The loaded shared library of ``csrc/<name>.cu``, built if needed."""
    return ctypes.CDLL(str(build([name])[name]))


def _gxx() -> str:
    gxx = shutil.which("g++")
    if not gxx:
        raise RuntimeError("g++ not found: put it on PATH to build the "
                           "native volume reader")
    return gxx


@functools.lru_cache(maxsize=None)
def gxx_identity(gxx: str, native: bool) -> str:
    """The compiler's ``--version`` and, with ``native``, the target
    options ``-march=native`` resolves to here: a library built for
    another CPU is never loaded."""
    cmd = ([gxx, "-march=native", "-Q", "--help=target"] if native
           else [gxx, "--version"])
    return subprocess.run(cmd, capture_output=True, text=True,
                          check=True).stdout


def _host_library_path(name: str, gxx: str, rung: str, cflags, lflags):
    src = CSRC / (name + ".cpp")
    key = (src.read_bytes() +
           " ".join(GXX_FLAGS + cflags + lflags).encode() +
           gxx_identity(gxx, False).encode() +
           gxx_identity(gxx, "-march=native" in cflags).encode())
    digest = hashlib.sha256(key).hexdigest()[:12]
    return BUILD_DIR / "lib{}-{}-{}.so".format(name, rung, digest)


def build_host(name: str = "medloader") -> Tuple[Path, str]:
    """Compile ``csrc/<name>.cpp`` with ``g++`` down :data:`HOST_LADDER`
    unless a rung's library is built already. Returns (library path, rung
    that built it); raises with the compiler's output of every rung when
    none builds. The library is written under a temporary name and moved
    into place, so processes that build at once never load half a file."""
    gxx = _gxx()
    rungs = [(rung, _host_library_path(name, gxx, rung, cflags, lflags),
              cflags, lflags) for rung, cflags, lflags in HOST_LADDER]
    for rung, path, _, _ in rungs:
        if path.exists():
            return path, rung
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    errors = []
    for rung, path, cflags, lflags in rungs:
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [gxx, *GXX_FLAGS, *cflags, str(CSRC / (name + ".cpp")), "-o",
               tmp, *lflags]
        proc = subprocess.run(cmd, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
        if proc.returncode == 0:
            os.replace(tmp, path)
            return path, rung
        os.unlink(tmp)
        errors.append("{} (g++ exit {}): {}\n{}".format(
            rung, proc.returncode, " ".join(cmd), proc.stdout))
    raise RuntimeError("host build of csrc/{}.cpp failed at every rung:\n"
                       "{}".format(name, "\n".join(errors)))
