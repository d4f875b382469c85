# Copyright 2026. Apache License 2.0.
"""Build the CUDA sources under ``medicalseg_torch/csrc`` and load them.

Each ``csrc/<name>.cu`` has a plain C interface. At first use it is
compiled with ``nvcc`` for ``sm_90a`` into ``build/torch_kernels/`` at the
root of the checkout (listed in ``.gitignore``) and loaded with
:mod:`ctypes`. The library's file name carries a hash of its source and
flags, so an edited source is rebuilt and a stale library is never loaded.
Nothing is compiled when a module is imported: the CPU tests import every
module on a machine with no ``nvcc``.
"""

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Dict, Iterable

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
SOURCES = ("conv5", "conv5_wgrad", "pin")


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
