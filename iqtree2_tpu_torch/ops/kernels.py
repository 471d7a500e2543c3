"""The pruning kernels written by hand for Hopper, with their plain versions.

Counterpart of iqtree2_tpu/ops/pallas_pruning.py and pallas_pruning2.py.
The CUDA source is ``iqtree2_tpu_torch/csrc/pruning.cu``; it is compiled with
``nvcc`` for ``sm_90a`` at first use into ``iqtree2_tpu_torch/_build/``
(keyed by a hash of the source and flags) and bound with ctypes.

Each kernel has, side by side here:

- a wrapper (``down_pass``, ``root_sitelp``, ``up_pass``, ``edge_theta``):
  for CUDA tensors it launches the kernel on the current stream or raises;
  for CPU tensors it runs the plain version;
- the plain PyTorch version (``*_plain``), device-agnostic, which is the CPU
  path and the reference the kernel is held to on the card; the passes'
  plain versions loop over ``down_step_plain`` / ``up_step_plain``, the
  step body the kernels repeat inside one launch;
- a launch counter in ``LAUNCHES``, incremented where the kernel launches.

What the kernels replace (TPU kernel: file · ``pl.pallas_call`` line):

- H1 ``down_pass``: pallas_pruning.down_pass_pallas :224 (T2) and the
  traversal of down_sitelp_pallas :452 (T1) and pallas_pruning2.stream_pass
  :342 in all three modes (T4, T5, T6).
- H2 ``root_sitelp``: the root reductions of down_sitelp_pallas
  (pallas_pruning.py:112-118) and stream_pass (pallas_pruning2.py:230-238).
- H3 ``up_pass``: pallas_pruning.up_pass_pallas :372 (T3),
  pallas_pruning2.stream_up_pass :567 (T7) and the sweep half of
  stream_theta_pass :804 (T8).
- H4 ``edge_theta``: the theta half of stream_theta_pass
  (pallas_pruning2.py:683-695) and ops/pruning.edge_thetas.

What bounds them on the card is memory bandwidth: at S=4 a step does under
2 flops per byte in float32. The TPU kernels packed categories into
[128, 128] block-diagonal operators to feed the matrix unit (32x the useful
work for DNA) and kept partials in a VMEM ring; here each category's S x S
block is contracted directly by one thread per pattern. Each pass is one
launch, as each Pallas pass was: a block owns a tile of patterns and walks
every level step of the schedule (csrc/pruning.cu says how), so a pass
costs one operand check and one launch on the host whatever the tree's
depth.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

from iqtree2_tpu_torch.ops.prec import scaling_consts

LAUNCHES = {"down_pass": 0, "root_sitelp": 0, "up_pass": 0, "edge_theta": 0}

# widest state space the kernels hold in registers (codon models: 61)
MAX_STATES = 64
# CUDA's limit on grid.y, which carries edge_theta's edge id
MAX_GRID_Y = 65535

_PKG = Path(__file__).resolve().parent.parent
SOURCE = _PKG / "csrc" / "pruning.cu"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")

_P, _I = ctypes.c_void_p, ctypes.c_int
# argument kinds of each extern "C" launcher, without the trailing stream
_SIGNATURES = {
    "down_pass": [_P] * 7 + [_I] * 7,
    "root_sitelp": [_P] * 8 + [_I] * 4,
    "up_pass": [_P] * 11 + [_I] * 7,
    "edge_theta": [_P] * 9 + [_I] * 4,
}
_SUFFIX = {torch.float32: "f32", torch.float64: "f64"}

_lib = None   # the loaded library, built on first use


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


# ---------------------------------------------------------------- building
def find_nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for cand in (shutil.which("nvcc"), os.path.join(cuda_home, "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (looked on PATH and in $CUDA_HOME/bin): "
                       "the CUDA kernels cannot be built")


def build_library() -> Path:
    """Compile csrc/pruning.cu unless a build of this exact source exists."""
    digest = hashlib.sha256(SOURCE.read_bytes()
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    out = BUILD_DIR / f"pruning_{digest}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [find_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed with code {res.returncode}:\n"
                           f"{' '.join(cmd)}\n{res.stdout}{res.stderr}")
    os.replace(tmp, out)
    return out


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare argtypes/restype of every launcher of a loaded library."""
    for name, args in _SIGNATURES.items():
        for suffix in _SUFFIX.values():
            fn = getattr(lib, f"iq_{name}_{suffix}")
            fn.argtypes = args + [_P]
            fn.restype = ctypes.c_int
    return lib


def library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        _lib = bind(ctypes.CDLL(str(build_library())))
    return _lib


def _call(lib, name: str, dtype: torch.dtype, stream: int, ptrs, ints) -> None:
    suffix = _SUFFIX.get(dtype)
    if suffix is None:
        raise TypeError(f"{name}: kernels take float32 or float64, not {dtype}")
    err = getattr(lib, f"iq_{name}_{suffix}")(*ptrs, *ints, stream)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")
    LAUNCHES[name] += 1


def _check_cuda(name: str, floats, ints) -> int:
    """Validate kernel operands; returns the current stream's handle."""
    dev = floats[0].device
    want = [(t, floats[0].dtype) for t in floats] + \
        [(t, torch.int32) for t in ints]
    for i, (t, dtype) in enumerate(want):
        if t.device != dev or t.dtype != dtype or not t.is_contiguous():
            raise ValueError(
                f"{name}: operand {i} must be a contiguous {dtype} tensor on "
                f"{dev}; got {t.dtype} on {t.device}"
                f"{'' if t.is_contiguous() else ', not contiguous'}")
    return torch.cuda.current_stream(dev).cuda_stream


def _check_states(name: str, S: int) -> None:
    if S > MAX_STATES:
        raise NotImplementedError(
            f"{name}: {S} states exceed the kernels' register column "
            f"({MAX_STATES}); wider state spaces are not yet ported")


# -------------------------------------------------------- plain contractions
def apply_P(P, x):
    """msg[..., x, p] = sum_y P[..., x, y] * x[..., y, p]."""
    return (P[..., :, :, None] * x[..., None, :, :]).sum(-2)


def apply_PT(P, x):
    """out[..., y, p] = sum_x P[..., x, y] * x[..., x, p]."""
    return (P[..., :, :, None] * x[..., :, None, :]).sum(-3)


def _rescale(v, count, thresh, factor):
    """Per-(node, pattern) underflow rescale over the trailing [C, S] block of
    v [..., C, S, Pp]; returns (v, count + events)."""
    need = v.amax(dim=(-3, -2)) < thresh
    return (torch.where(need[..., None, None, :], v * factor, v),
            count + need.to(count.dtype))


def root_lp(Broot, SCroot, root_freqs, cat_weight, log_ptn_invar):
    """Site log-likelihoods from the combined root partial [C, S, Pp]."""
    dtype = Broot.dtype
    _, _, log_rescale = scaling_consts(dtype)
    lh_cat = (root_freqs[:, :, None] * Broot).sum(1)
    site = (cat_weight[:, None] * lh_cat).sum(0)
    tiny = torch.finfo(dtype).tiny
    lp = torch.log(site.clamp(min=tiny)) - SCroot.to(dtype) * log_rescale
    return torch.logaddexp(lp, log_ptn_invar)


# ---------------------------------------------------------------- H1
def down_pass(P, tip, all_, sc, child_src, child_edge, step_node) -> None:
    """The whole postorder pass, in place: for every level step of
    ``step_node`` in order and every node of it (pad slots = n_int are
    skipped), write its partial and scale count into the unified buffers
    ``all_`` [L+n_int, C, S, Pp] and ``sc`` [L+n_int, Pp]. Tip rows of
    ``all_`` are neither read nor written (tips come from ``tip``).

    P [E, C, S, S]; tip [L, S, Pp]; child_src/child_edge [n_int, 2] int32;
    step_node [n_steps, G] int32. Contract of pruning._down_pass_xla.
    """
    if not all_.is_cuda:
        down_pass_plain(P, tip, all_, sc, child_src, child_edge, step_node)
        return
    stream = _check_cuda("down_pass", (P, tip, all_),
                         (sc, child_src, child_edge, step_node))
    launch_down_pass(library(), stream, P, tip, all_, sc, child_src,
                     child_edge, step_node)


def launch_down_pass(lib, stream, P, tip, all_, sc, child_src, child_edge,
                     step_node) -> None:
    L, S, Pp = tip.shape
    _check_states("down_pass", S)
    n_steps, G = step_node.shape
    _call(lib, "down_pass", all_.dtype, stream,
          [t.data_ptr() for t in (P, tip, all_, sc, child_src, child_edge,
                                  step_node)],
          [n_steps, G, child_src.shape[0], L, P.shape[1], S, Pp])


def down_pass_plain(P, tip, all_, sc, child_src, child_edge,
                    step_node) -> None:
    for row in step_node:
        down_step_plain(P, tip, all_, sc, child_src, child_edge, row)


def down_step_plain(P, tip, all_, sc, child_src, child_edge, step_row) -> None:
    """One level step of the down pass (the kernel's step body)."""
    L = tip.shape[0]
    thresh, factor, _ = scaling_consts(all_.dtype)
    nid = step_row[step_row < child_src.shape[0]].long()
    if nid.numel() == 0:
        return
    src = child_src[nid].long()                       # [g, 2]
    msg = apply_P(P[child_edge[nid].long()], all_[src])   # [g, 2, C, S, Pp]
    prod, cnt = _rescale(msg[:, 0] * msg[:, 1], sc[src[:, 0]] + sc[src[:, 1]],
                         thresh, factor)
    all_[L + nid] = prod
    sc[L + nid] = cnt


# ---------------------------------------------------------------- H2
def root_sitelp(P, tip, all_, sc, root_row: int, root_freqs, cat_weight,
                log_ptn_invar):
    """Site log-likelihoods lp [Pp]: fold leaf 0's message P[0]·tip[0] into
    the root partial ``all_[root_row]``, weight by cat_weight x root_freqs,
    log, subtract the scale, logaddexp the invariant-site term."""
    if not all_.is_cuda:
        return root_sitelp_plain(P, tip, all_, sc, root_row, root_freqs,
                                 cat_weight, log_ptn_invar)
    stream = _check_cuda("root_sitelp",
                         (P, tip, all_, root_freqs, cat_weight, log_ptn_invar),
                         (sc,))
    return launch_root_sitelp(library(), stream, P, tip, all_, sc, root_row,
                              root_freqs, cat_weight, log_ptn_invar)


def launch_root_sitelp(lib, stream, P, tip, all_, sc, root_row, root_freqs,
                       cat_weight, log_ptn_invar):
    _, S, Pp = tip.shape
    _check_states("root_sitelp", S)
    lp = torch.empty(Pp, dtype=all_.dtype, device=all_.device)
    _call(lib, "root_sitelp", all_.dtype, stream,
          [t.data_ptr() for t in (P, tip, all_, sc, root_freqs, cat_weight,
                                  log_ptn_invar, lp)],
          [root_row, P.shape[1], S, Pp])
    return lp


def root_sitelp_plain(P, tip, all_, sc, root_row, root_freqs, cat_weight,
                      log_ptn_invar):
    m0 = apply_P(P[0], tip[0])                        # [C, S, Pp]
    return root_lp(all_[root_row] * m0, sc[root_row], root_freqs,
                   cat_weight, log_ptn_invar)


# ---------------------------------------------------------------- H3
def up_pass(P, tip, all_, dsc, up, upsc, E, esc, child_src, child_edge,
            step_node) -> None:
    """The whole pre-order sweep, in place: for the level steps of
    ``step_node`` in reverse order, every node of a step and child slot k,
    E[edge_k] = UP(node) x msg(sibling), rescaled, and for internal
    children UP(child) = P_k^T E[edge_k], rescaled. UP of the root and E of
    edge 0 must be set before (pruning.up_buffers).

    all_/dsc: down partials and scales (unified); up/upsc [n_int, ...];
    E/esc [n_edges, ...]. Contract of pruning._up_pass_xla.
    """
    if not up.is_cuda:
        up_pass_plain(P, tip, all_, dsc, up, upsc, E, esc, child_src,
                      child_edge, step_node)
        return
    stream = _check_cuda("up_pass", (P, tip, all_, up, E),
                         (dsc, upsc, esc, child_src, child_edge, step_node))
    launch_up_pass(library(), stream, P, tip, all_, dsc, up, upsc, E, esc,
                   child_src, child_edge, step_node)


def launch_up_pass(lib, stream, P, tip, all_, dsc, up, upsc, E, esc,
                   child_src, child_edge, step_node) -> None:
    L, S, Pp = tip.shape
    _check_states("up_pass", S)
    n_steps, G = step_node.shape
    _call(lib, "up_pass", up.dtype, stream,
          [t.data_ptr() for t in (P, tip, all_, dsc, up, upsc, E, esc,
                                  child_src, child_edge, step_node)],
          [n_steps, G, child_src.shape[0], L, P.shape[1], S, Pp])


def up_pass_plain(P, tip, all_, dsc, up, upsc, E, esc, child_src, child_edge,
                  step_node) -> None:
    for s in range(step_node.shape[0] - 1, -1, -1):
        up_step_plain(P, tip, all_, dsc, up, upsc, E, esc, child_src,
                      child_edge, step_node[s])


def up_step_plain(P, tip, all_, dsc, up, upsc, E, esc, child_src, child_edge,
                  step_row) -> None:
    """One level step of the up pass (the kernel's step body)."""
    L = tip.shape[0]
    thresh, factor, _ = scaling_consts(up.dtype)
    nid = step_row[step_row < child_src.shape[0]].long()
    if nid.numel() == 0:
        return
    src = child_src[nid].long()                       # [g, 2]
    eid = child_edge[nid].long()
    Pe = P[eid]                                       # [g, 2, C, S, S]
    msg = apply_P(Pe, all_[src])
    # E for slot k = UP(node) * message of the other slot
    Es, Esc = _rescale(up[nid][:, None] * msg.flip(1),
                       upsc[nid][:, None] + dsc[src].flip(1), thresh, factor)
    E[eid] = Es
    esc[eid] = Esc
    upc, upc_sc = _rescale(apply_PT(Pe, Es), Esc, thresh, factor)
    is_int = src >= L
    up[src[is_int] - L] = upc[is_int]
    upsc[src[is_int] - L] = upc_sc[is_int]


# ---------------------------------------------------------------- H4
def edge_theta(E, esc, all_, dsc, edge_src, U, V):
    """theta[e, c, k, p] = (sum_x E[e,c,x,p] U[c,x,k]) (sum_y V[c,k,y]
    all_[edge_src[e],c,y,p]) and its scale esc[e] + dsc[edge_src[e]].

    U/V: [C, S, S] per-category eigenvectors. Returns (theta, scale)."""
    if not E.is_cuda:
        return edge_theta_plain(E, esc, all_, dsc, edge_src, U, V)
    stream = _check_cuda("edge_theta", (E, all_, U, V), (esc, dsc, edge_src))
    return launch_edge_theta(library(), stream, E, esc, all_, dsc, edge_src,
                             U, V)


def launch_edge_theta(lib, stream, E, esc, all_, dsc, edge_src, U, V):
    n_edges, C, S, Pp = E.shape
    _check_states("edge_theta", S)
    if n_edges > MAX_GRID_Y:
        raise NotImplementedError(f"edge_theta: {n_edges} edges exceed the "
                                  f"grid's y limit ({MAX_GRID_Y})")
    theta = torch.empty_like(E)
    tsc = torch.empty_like(esc)
    _call(lib, "edge_theta", E.dtype, stream,
          [t.data_ptr() for t in (E, esc, all_, dsc, edge_src, U, V, theta,
                                  tsc)],
          [n_edges, C, S, Pp])
    return theta, tsc


def edge_theta_plain(E, esc, all_, dsc, edge_src, U, V):
    src = edge_src.long()
    return apply_PT(U, E) * apply_P(V, all_[src]), esc + dsc[src]
