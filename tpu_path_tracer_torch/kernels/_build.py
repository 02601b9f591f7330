"""Build the port's CUDA sources into one shared library with ``nvcc``.

The library has a plain C interface and is loaded with ``ctypes``; no
PyTorch header is compiled, so a build takes seconds.  It is built at first
use from the ``.cu`` files under ``tpu_path_tracer_torch/csrc/`` into
``tpu_path_tracer_torch/_build/``, under a name keyed by a hash of the
sources, the headers they include (``.cuh``) and the flags, so an edited
source or header is rebuilt and an unchanged one is not.  Each source is
compiled by its own ``nvcc``, all started together, and the objects are
linked into the library.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
from pathlib import Path

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"
# --fmad=false: no a*b+c contraction, matching the references' rounding
# (see the note at the top of csrc/tracer.cuh).  -Xptxas -v reports
# registers, shared memory and spills into the build log.
GENCODE = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = (*GENCODE, "-std=c++17", "-O3", "--fmad=false", "-Xptxas", "-v",
              "-Xcompiler", "-fPIC")

# The traversal's walk built for the host (load_host_walk): g++ with no
# a*b+c contraction, as nvcc's --fmad=false.
HOST_FLAGS = ("-O1", "-std=c++17", "-ffp-contract=off", "-shared", "-fPIC",
              "-x", "c++")

_lib = None


def nvcc_path() -> str:
    """``nvcc`` from PATH, else the CUDA toolkit's default location."""
    found = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(found):
        raise RuntimeError("nvcc not found on PATH or at "
                           "/usr/local/cuda/bin/nvcc; the CUDA kernels need "
                           "the CUDA toolkit")
    return found


def build(csrc_dir: Path = CSRC_DIR, build_dir: Path = BUILD_DIR) -> Path:
    """Compile the sources of ``csrc_dir`` into ``build_dir`` if this exact
    build is missing there; returns the library's path.  A failed build
    raises with nvcc's output."""
    sources = sorted(csrc_dir.glob("*.cu"))
    headers = sorted(csrc_dir.glob("*.cuh"))
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources + headers:
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    lib_path = build_dir / f"libtpt_kernels_{digest.hexdigest()[:16]}.so"
    if lib_path.exists():
        return lib_path
    build_dir.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    stem = f"{lib_path.stem}.{os.getpid()}"
    objects = [build_dir / f"{stem}.{src.stem}.o" for src in sources]
    tmp = build_dir / f"{stem}.so.tmp"
    procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", "-o", str(obj),
                               str(src)], stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for src, obj in zip(sources, objects)]
    logs = [proc.communicate()[0] for proc in procs]
    try:
        for src, proc, log in zip(sources, procs, logs):
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed on {src.name} (exit "
                                   f"{proc.returncode}):\n{log}")
        cmd = [nvcc, "-shared", *GENCODE, "-o", str(tmp),
               *map(str, objects)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc link failed (exit {proc.returncode}):"
                               f"\n{' '.join(cmd)}\n{proc.stdout}"
                               f"{proc.stderr}")
        lib_path.with_suffix(".log").write_text("".join(logs))
        os.replace(tmp, lib_path)
    finally:
        for path in objects + [tmp]:
            path.unlink(missing_ok=True)
    return lib_path


def load() -> ctypes.CDLL:
    """The built library, loaded once per process."""
    global _lib
    if _lib is None:
        _lib = ctypes.CDLL(str(build()))
    return _lib


def load_host_walk(csrc_dir: Path = CSRC_DIR,
                   build_dir: Path = BUILD_DIR) -> ctypes.CDLL:
    """``traversal.cu`` built for the host with g++ into ``build_dir`` if
    this build is missing there, and loaded.  Without nvcc the file leaves
    out its kernels and keeps the walk and the packer with their host entry
    points (``tpt_bvh_walk_host``, ``tpt_bvh_pack_host``): the count of a
    walk's work where there is no CUDA toolkit, and the kernel's code on
    the CPU in the tests.  Raises without g++."""
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError("g++ not found on PATH; the host build of the "
                           "traversal needs a C++ compiler")
    digest = hashlib.sha256(" ".join(HOST_FLAGS).encode())
    for src in [csrc_dir / "traversal.cu", *sorted(csrc_dir.glob("*.cuh"))]:
        digest.update(src.read_bytes())
    lib_path = build_dir / f"libtpt_walk_{digest.hexdigest()[:16]}.so"
    if not lib_path.exists():
        build_dir.mkdir(parents=True, exist_ok=True)
        tmp = build_dir / f"{lib_path.name}.{os.getpid()}.tmp"
        proc = subprocess.run([gxx, *HOST_FLAGS, "-I", str(csrc_dir), "-o",
                               str(tmp), str(csrc_dir / "traversal.cu")],
                              capture_output=True, text=True, timeout=300)
        if proc.returncode != 0:
            raise RuntimeError(f"g++ failed on traversal.cu:\n{proc.stderr}")
        os.replace(tmp, lib_path)
    return ctypes.CDLL(str(lib_path))


def ptxas_report(log: str, name: str) -> dict:
    """What ``-Xptxas -v`` says in a build log of the one kernel whose
    mangled name holds ``name``: ``{"registers", "smem_bytes" (static),
    "spill_bytes" (stores plus loads), "stack_bytes"}``."""
    entry, props, out = None, None, {}
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            entry = m.group(1)
            out[entry] = {"registers": None, "smem_bytes": 0,
                          "spill_bytes": 0, "stack_bytes": 0}
            continue
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            props = m.group(1)
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m and props in out:
            out[props]["stack_bytes"] = int(m.group(1))
            out[props]["spill_bytes"] = int(m.group(2)) + int(m.group(3))
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m and entry in out:
            out[entry]["registers"] = int(m.group(1))
            smem = re.search(r"(\d+) bytes smem", line)
            out[entry]["smem_bytes"] = int(smem.group(1)) if smem else 0
    found = [v for k, v in out.items() if name in k]
    if len(found) != 1:
        raise ValueError(f"{len(found)} kernels named {name} in the log")
    return found[0]
