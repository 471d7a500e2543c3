"""ctypes bindings for the port's native host runtime (csrc/host_native.cpp).

The library is built with g++ at first use into iqtree2_tpu_torch/_build/
(keyed by a hash of the source, as the CUDA kernels are); every entry point
has a numpy fallback in its caller, taken when no toolchain is present.
Covered components (reference analogs in the .cpp):
  - pattern compression (alignment/alignment.cpp:1725)
  - bit-parallel Fitch scoring (tree/phylotreepars.cpp:32)
  - the edge costs of a stepwise-addition step (pll/fastDNAparsimony.c)

Copied from iqtree2_tpu/native.py, the two functions the port calls (its
streaming-plan entry point feeds only the TPU kernels), plus
stepwise_costs, the port's own: the port keeps its own host modules and
imports nothing of the JAX package.
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
_MASK_SUFFIX = {np.dtype(np.uint8): "u8", np.dtype(np.uint32): "u32",
                np.dtype(np.uint64): "u64"}
STEPWISE_TILE = 1024  # patterns per tile of it2_stepwise_costs
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
            vp = ctypes.c_void_p
            for suffix in _MASK_SUFFIX.values():
                fn = getattr(lib, f"it2_stepwise_costs_{suffix}")
                fn.restype = None
                fn.argtypes = [vp, vp, i32p, i64, i32p, i32p, i32p, i32p,
                               i64, i64, vp, vp, vp,
                               ctypes.POINTER(ctypes.c_int64)]
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


class StepwiseCosts:
    """The edge costs of every step of one stepwise addition (native),
    with its scratch allocated once for trees of up to n_nodes nodes.
    masks [L, P] are held in the narrowest unsigned type that holds
    them; the weights are pattern counts, summed as integers."""

    def __init__(self, masks: np.ndarray, weights: np.ndarray,
                 n_nodes: int):
        top = int(masks.max()) if masks.size else 0
        dtype = np.uint8 if top < 1 << 8 else \
            np.uint32 if top < 1 << 32 else np.uint64
        self.masks = np.ascontiguousarray(masks, dtype=dtype)
        self.w = np.ascontiguousarray(weights, dtype=np.int32)
        self.fn = getattr(_load(), f"it2_stepwise_costs_"
                                   f"{_MASK_SUFFIX[np.dtype(dtype)]}")
        tile = min(STEPWISE_TILE, self.masks.shape[1])
        self.tile = tile
        self.down = np.empty((n_nodes, tile), dtype)
        self.up = np.empty((n_nodes, tile), dtype)
        self.has_up = np.empty(n_nodes, np.uint8)

    def __call__(self, leaf: int, post_v, post_p, kid_off,
                 kids) -> np.ndarray:
        """Cost [edges] of inserting ``leaf`` on each edge (v, p) of the
        postorder post_v/post_p with p >= 0, in that order."""
        post_v = np.ascontiguousarray(post_v, np.int32)
        post_p = np.ascontiguousarray(post_p, np.int32)
        kid_off = np.ascontiguousarray(kid_off, np.int32)
        kids = np.ascontiguousarray(kids, np.int32)
        cost = np.empty(int((post_p >= 0).sum()), np.int64)
        x = self.masks[leaf]
        self.fn(self.masks.ctypes.data, x.ctypes.data,
                _ptr(self.w, ctypes.c_int32), self.masks.shape[1],
                _ptr(post_v, ctypes.c_int32), _ptr(post_p, ctypes.c_int32),
                _ptr(kid_off, ctypes.c_int32), _ptr(kids, ctypes.c_int32),
                len(post_v), self.tile, self.down.ctypes.data,
                self.up.ctypes.data, self.has_up.ctypes.data,
                _ptr(cost, ctypes.c_int64))
        return cost.astype(np.float64)


def stepwise_costs(masks: np.ndarray, weights: np.ndarray,
                   n_nodes: int) -> StepwiseCosts | None:
    """A StepwiseCosts for these masks, or None when native is
    unavailable or the weights are not whole counts below 2^31 in sum."""
    w = np.asarray(weights)
    if _load() is None or not (np.all(w == np.round(w)) and w.min() >= 0
                               and w.sum() < 2 ** 31):
        return None
    return StepwiseCosts(masks, weights, n_nodes)
