"""Build the port's CUDA sources into one shared library with ``nvcc``.

The library has a plain C interface and is loaded with ``ctypes``; no
PyTorch header is compiled, so a build takes seconds.  It is built at first
use from the ``.cu`` files under ``tpu_path_tracer_torch/csrc/`` into
``tpu_path_tracer_torch/_build/``, under a name keyed by a hash of the
sources, the headers they include (``.cuh``) and the flags, so an edited
source or header is rebuilt and an unchanged one is not.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"
# --fmad=false: no a*b+c contraction, matching the references' rounding
# (see the note at the top of csrc/tracer.cuh).  -Xptxas -v reports
# registers, shared memory and spills into the build log.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "--fmad=false", "-Xptxas", "-v", "-shared",
              "-Xcompiler", "-fPIC")

_lib = None


def nvcc_path() -> str:
    """``nvcc`` from PATH, else the CUDA toolkit's default location."""
    found = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(found):
        raise RuntimeError("nvcc not found on PATH or at "
                           "/usr/local/cuda/bin/nvcc; the CUDA kernels need "
                           "the CUDA toolkit")
    return found


def build() -> Path:
    """Compile the sources if this exact build is missing; returns the
    library's path.  A failed build raises with nvcc's output."""
    sources = sorted(CSRC_DIR.glob("*.cu"))
    headers = sorted(CSRC_DIR.glob("*.cuh"))
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources + headers:
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    lib_path = BUILD_DIR / f"libtpt_kernels_{digest.hexdigest()[:16]}.so"
    if lib_path.exists():
        return lib_path
    BUILD_DIR.mkdir(exist_ok=True)
    tmp = lib_path.with_name(f"{lib_path.name}.{os.getpid()}.tmp")
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), *map(str, sources)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed (exit {proc.returncode}):\n"
                           f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
    lib_path.with_suffix(".log").write_text(proc.stdout + proc.stderr)
    os.replace(tmp, lib_path)
    return lib_path


def load() -> ctypes.CDLL:
    """The built library, loaded once per process."""
    global _lib
    if _lib is None:
        _lib = ctypes.CDLL(str(build()))
    return _lib
