"""ctypes bindings for the native (C++) BVH builders and OBJ de-indexer
(``tpu_path_tracer.accel.native``).

``bvh_native.cpp`` is host code.  It is compiled with ``g++`` at first use
into ``tpu_path_tracer_torch/_build/``, under a name keyed by a hash of the
source, the flags and the host's CPU (``-march=native`` builds for the CPU
that compiles, so a library built on one host is never loaded on
another), with the JAX package's flags and C ABI.  Without a compiler the
functions here return None and the callers run the NumPy builders of
``accel.bvh``, the reference implementation.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Optional

import numpy as np

from .bvh import FlatBVHArrays

_SRC = Path(__file__).with_name("bvh_native.cpp")
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
GXX_FLAGS = ("-O3", "-march=native", "-fPIC", "-shared", "-std=c++17")

_lib: Optional[ctypes.CDLL] = None
_lib_failed = False


def host_key(gxx: str) -> str:
    """What ``-march=native`` selects on this host: the target options
    ``g++ -march=native -Q --help=target`` reports."""
    return subprocess.run([gxx, "-march=native", "-Q", "--help=target"],
                          check=True, capture_output=True, text=True).stdout


def library_path(host: str) -> Path:
    """The library's path for the CPU that ``host`` (:func:`host_key`)
    describes: a hash of the flags, the source and the host."""
    digest = hashlib.sha256(" ".join(GXX_FLAGS).encode())
    digest.update(_SRC.read_bytes())
    digest.update(host.encode())
    return BUILD_DIR / f"libtptbvh_{digest.hexdigest()[:16]}.so"


def _build_lib() -> Optional[ctypes.CDLL]:
    global _lib, _lib_failed
    if _lib is not None or _lib_failed:
        return _lib
    gxx = shutil.which("g++")
    if gxx is None:
        _lib_failed = True
        return None
    try:
        so = library_path(host_key(gxx))
        if not so.exists():
            BUILD_DIR.mkdir(exist_ok=True)
            tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
            subprocess.run([gxx, *GXX_FLAGS, str(_SRC), "-o", str(tmp)],
                           check=True, capture_output=True)
            os.replace(tmp, so)
        lib = ctypes.CDLL(str(so))
    except (OSError, subprocess.CalledProcessError):
        _lib_failed = True
        return None
    lib.tpt_bvh_build.restype = ctypes.c_int64
    lib.tpt_obj_parse.restype = ctypes.c_int64
    _lib = lib
    return _lib


def available() -> bool:
    return _build_lib() is not None


def _cptr(a, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def build_bvh_native(method: str, mins: np.ndarray, maxs: np.ndarray,
                     leaf_param: int) -> Optional[FlatBVHArrays]:
    """Native builder with the same output contract as ``accel.bvh``'s
    NumPy builders; returns None when the native path is unavailable."""
    lib = _build_lib()
    if lib is None:
        return None
    n = len(mins)
    mins = np.ascontiguousarray(mins, np.float32)
    maxs = np.ascontiguousarray(maxs, np.float32)
    cap = max(2 * n, 1)
    node_mins = np.empty((cap, 3), np.float32)
    node_maxs = np.empty((cap, 3), np.float32)
    right = np.empty(cap, np.int32)
    prim_start = np.empty(cap, np.int32)
    prim_count = np.empty(cap, np.int32)
    miss = np.empty(cap, np.int32)
    axis = np.empty(cap, np.int32)
    order = np.empty(max(n, 1), np.int64)
    scratch = np.empty(cap, np.int64)
    count = lib.tpt_bvh_build(
        method.encode(), ctypes.c_int64(n),
        _cptr(mins, ctypes.c_float), _cptr(maxs, ctypes.c_float),
        ctypes.c_int64(leaf_param),
        _cptr(node_mins, ctypes.c_float), _cptr(node_maxs, ctypes.c_float),
        _cptr(right, ctypes.c_int32), _cptr(prim_start, ctypes.c_int32),
        _cptr(prim_count, ctypes.c_int32), _cptr(miss, ctypes.c_int32),
        _cptr(axis, ctypes.c_int32), _cptr(order, ctypes.c_int64),
        _cptr(scratch, ctypes.c_int64))
    if count < 0:
        return None
    # Subtree triangle ranges (see _Builder.finish in accel/bvh.py): lo by
    # reverse scan over preorder, hi via the skip pointer.
    is_leaf = prim_count[:count] > 0
    lo = np.empty(count + 1, np.int32)
    lo[count] = n
    for i in range(count - 1, -1, -1):
        lo[i] = prim_start[i] if is_leaf[i] else lo[i + 1]
    return FlatBVHArrays(
        mins=node_mins[:count], maxs=node_maxs[:count], right=right[:count],
        prim_start=prim_start[:count], prim_count=prim_count[:count],
        miss=miss[:count], axis=axis[:count], order=order[:n],
        prim_lo=lo[:count], prim_hi=lo[miss[:count]])


def parse_obj_native(text: str):
    """Native OBJ de-indexer; returns (vertices [T*3,3], normals [T*3,3])
    or None when unavailable."""
    lib = _build_lib()
    if lib is None:
        return None
    raw = text.encode()
    buf = ctypes.create_string_buffer(raw, len(raw))
    corners = lib.tpt_obj_parse(buf, ctypes.c_int64(len(raw)),
                                ctypes.c_int(1), None, None)
    if corners < 0:
        return None
    verts = np.empty((corners, 3), np.float32)
    norms = np.empty((corners, 3), np.float32)
    lib.tpt_obj_parse(buf, ctypes.c_int64(len(raw)), ctypes.c_int(0),
                      _cptr(verts, ctypes.c_float),
                      _cptr(norms, ctypes.c_float))
    return verts, norms
