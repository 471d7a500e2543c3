"""ctypes bindings for the port's native host runtime (csrc/host_native.cpp).

The library is built with g++ at first use into iqtree2_tpu_torch/_build/
(keyed by a hash of the source, as the CUDA kernels are); every entry point
has a numpy fallback in its caller, taken when no toolchain is present.
Covered components (reference analogs in the .cpp):
  - pattern compression (alignment/alignment.cpp:1725)
  - bit-parallel Fitch scoring (tree/phylotreepars.cpp:32)

Copied from iqtree2_tpu/native.py, the two functions the port calls (its
streaming-plan entry point feeds only the TPU kernels): the port keeps its
own host modules and imports nothing of the JAX package.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

_PKG = Path(__file__).resolve().parent
_SRC = _PKG / "csrc" / "host_native.cpp"
_BUILD = _PKG / "_build"
_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")
_lock = threading.Lock()
_lib = None
_tried = False


def _build() -> Path:
    """Compile csrc/host_native.cpp unless a build of this source exists."""
    digest = hashlib.sha256(_SRC.read_bytes()
                            + " ".join(_FLAGS).encode()).hexdigest()[:16]
    out = _BUILD / f"host_native_{digest}.so"
    if not out.exists():
        _BUILD.mkdir(exist_ok=True)
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        subprocess.run(["g++", *_FLAGS, "-o", str(tmp), str(_SRC)],
                       check=True, capture_output=True, timeout=120)
        os.replace(tmp, out)
    return out


def _load():
    global _lib, _tried
    with _lock:
        if _tried:
            return _lib
        _tried = True
        try:
            lib = ctypes.CDLL(str(_build()))
            i32p = ctypes.POINTER(ctypes.c_int32)
            u64p = ctypes.POINTER(ctypes.c_uint64)
            f64p = ctypes.POINTER(ctypes.c_double)
            i64 = ctypes.c_int64
            lib.it2_compress_patterns.restype = i64
            lib.it2_compress_patterns.argtypes = [i32p, i64, i64, i32p,
                                                  f64p, i32p]
            lib.it2_fitch_score.restype = ctypes.c_double
            lib.it2_fitch_score.argtypes = [u64p, f64p, i32p, i64, i64,
                                            i64, u64p]
            _lib = lib
        except (OSError, subprocess.SubprocessError):
            _lib = None
        return _lib


def _ptr(a, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def available() -> bool:
    return _load() is not None


def compress_patterns(codes: np.ndarray):
    """codes [L, nsites] int32 -> (patterns [nsites_unique, L] int,
    weights, site_to_pattern) or None when native is unavailable."""
    lib = _load()
    if lib is None:
        return None
    codes = np.ascontiguousarray(codes, dtype=np.int32)
    L, nsites = codes.shape
    out_p = np.empty((L, nsites), np.int32)
    out_w = np.empty(nsites, np.float64)
    out_s = np.empty(nsites, np.int32)
    n = lib.it2_compress_patterns(
        _ptr(codes, ctypes.c_int32), L, nsites,
        _ptr(out_p, ctypes.c_int32), _ptr(out_w, ctypes.c_double),
        _ptr(out_s, ctypes.c_int32))
    return out_p[:, :n].T.copy(), out_w[:n].copy(), out_s


def fitch_score(masks: np.ndarray, weights: np.ndarray,
                child_src: np.ndarray) -> float | None:
    """Weighted Fitch cost over a postorder schedule (native)."""
    lib = _load()
    if lib is None:
        return None
    masks = np.ascontiguousarray(masks, dtype=np.uint64)
    w = np.ascontiguousarray(weights, dtype=np.float64)
    cs = np.ascontiguousarray(child_src, dtype=np.int32)
    L, P = masks.shape
    n_int = cs.shape[0]
    scratch = np.empty(((L + n_int), P), np.uint64)
    return float(lib.it2_fitch_score(
        _ptr(masks, ctypes.c_uint64), _ptr(w, ctypes.c_double),
        _ptr(cs, ctypes.c_int32), n_int, L, P,
        _ptr(scratch, ctypes.c_uint64)))
