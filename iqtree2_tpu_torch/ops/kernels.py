"""The pruning kernels written by hand for Hopper, with their plain versions.

Counterpart of iqtree2_tpu/ops/pallas_pruning.py and pallas_pruning2.py.
The CUDA source is ``iqtree2_tpu_torch/csrc/pruning.cu``; it is compiled with
``nvcc`` for ``sm_90a`` at first use into ``iqtree2_tpu_torch/_build/``
(one part per pass and precision, side by side, keyed by a hash of the
source and flags) and bound with ctypes.

Each kernel has, side by side here:

- a wrapper (``down_pass``, ``up_pass``, ``theta_pass``): for CUDA tensors
  it launches the kernel on the current stream or raises; for CPU tensors it
  runs the plain version;
- the plain PyTorch version (``*_plain``), device-agnostic, which is the CPU
  path and the reference the kernel is held to on the card; the passes'
  plain versions loop over ``down_step_plain`` / ``up_step_plain``, the
  step body the kernels repeat inside one launch, and the epilogue and the
  theta half are ``root_sitelp_plain`` and ``edge_theta_plain``;
- a launch counter in ``LAUNCHES``, incremented where the kernel launches
  (``sitelp`` counts the down passes that ran the site-logL epilogue).

What the kernels replace (TPU kernel: file · ``pl.pallas_call`` line):

- H1 ``down_pass``: pallas_pruning.down_pass_pallas :224 (T2),
  down_sitelp_pallas :452 (T1) with its root reduction
  (pallas_pruning.py:112-118) as the epilogue, and
  pallas_pruning2.stream_pass :342 in all three modes (T4 with its root
  reduction, pallas_pruning2.py:230-238, as the epilogue; T5, T6).
- H2 ``up_pass``: pallas_pruning.up_pass_pallas :372 (T3) and
  pallas_pruning2.stream_up_pass :567 (T7).
- H3 ``theta_pass``: pallas_pruning2.stream_theta_pass :804 (T8): the sweep
  with theta formed per edge inside it (pallas_pruning2.py:683-695) and
  the root set up in its first step (:651-659).

What bounds them on the card is memory bandwidth: at S=4 a step does under
2 flops per byte in float32 (past 64 states, about 37 at S = 112, the
products' arithmetic bounds them instead). The TPU kernels packed
categories into [128, 128] block-diagonal operators to feed the matrix
unit (32x the useful work for DNA) and kept partials in a VMEM ring; here
a block owns a tile of 32 patterns and walks every level step of the
schedule, a warp per node slot and a thread per pattern contracting each
category's S x S block directly; above 64 states the wide instance splits
a node's states across the block's warps: the down pass and the sweeps as
warp items of 16 states over K-chunks staged by cp.async (float64 on the
tensor cores, float32 register-tiled), a pattern tile of 32, 16 or 8
chosen to fill the card (csrc/pruning.cu says how; any S, any C). Each pass is one launch,
as each Pallas pass was, so a pass costs one operand check and one launch
on the host whatever the tree's depth; the site log-likelihoods and theta
are computed inside the pass that produces their inputs, as on the TPU.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
from pathlib import Path

import torch

from iqtree2_tpu_torch.ops.prec import scaling_consts

LAUNCHES = {"down_pass": 0, "sitelp": 0, "up_pass": 0, "theta_pass": 0}

_PKG = Path(__file__).resolve().parent.parent
SOURCE = _PKG / "csrc" / "pruning.cu"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")

_P, _I = ctypes.c_void_p, ctypes.c_int
# argument kinds of each extern "C" launcher, without the trailing stream
_SIGNATURES = {
    "down_pass": [_P] * 11 + [_I] * 7,
    "up_pass": [_P] * 11 + [_I] * 7,
    "theta_pass": [_P] * 14 + [_I] * 7,
}
_SUFFIX = {torch.float32: "f32", torch.float64: "f64"}
# kinds of pass_occupancy (csrc/pruning.cu's iq_pass_occupancy_KIND_SUFFIX)
PASS_KINDS = ("down_pass", "up_pass", "theta_pass")

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


def _run_all(cmds: list, logs: list) -> None:
    """Run the commands side by side, each writing to its log; raise with
    the log of the first that fails."""
    procs = []
    for cmd, log in zip(cmds, logs):
        with open(log, "w") as f:
            procs.append(subprocess.Popen(cmd, stdout=f,
                                          stderr=subprocess.STDOUT))
    codes = [p.wait() for p in procs]
    for cmd, log, code in zip(cmds, logs, codes):
        if code != 0:
            raise RuntimeError(f"nvcc failed with code {code}:\n"
                               f"{' '.join(cmd)}\n{Path(log).read_text()}")


def build_parts(source: bytes) -> list[int]:
    """The IQ_PART units of csrc/pruning.cu (its ``IQ_PART == k`` blocks,
    one pass and precision each), which build_library compiles side by
    side: one nvcc for the whole source took 40-53 s on the H100's host."""
    return sorted({int(k) for k in re.findall(rb"IQ_PART == (\d+)", source)})


def build_library() -> Path:
    """Compile csrc/pruning.cu unless a build of this exact source exists:
    one nvcc for each of its build_parts (a pass and a precision: its
    launcher, its occupancy query and its kernel instances), all started
    together, then one link."""
    source = SOURCE.read_bytes()
    digest = hashlib.sha256(source + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    out = BUILD_DIR / f"pruning_{digest}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    nvcc = find_nvcc()
    parts = build_parts(source)
    objs = [f"{tmp}.{k}.o" for k in parts]
    compile_flags = [f for f in NVCC_FLAGS if f != "-shared"] + ["-c"]
    try:
        _run_all([[nvcc, *compile_flags, f"-DIQ_PART={k}", "-o", obj,
                   str(SOURCE)] for k, obj in zip(parts, objs)],
                 [f"{obj}.log" for obj in objs])
        _run_all([[nvcc, "-shared", "-o", str(tmp), *objs]], [f"{tmp}.log"])
        os.replace(tmp, out)
    finally:
        for f in objs + [f"{o}.log" for o in objs] + [f"{tmp}.log"]:
            Path(f).unlink(missing_ok=True)
    return out


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare argtypes/restype of every launcher of a loaded library."""
    for suffix in _SUFFIX.values():
        for name, args in _SIGNATURES.items():
            fn = getattr(lib, f"iq_{name}_{suffix}")
            fn.argtypes = args + [_P]
            fn.restype = ctypes.c_int
        for kind in PASS_KINDS:
            fn = getattr(lib, f"iq_pass_occupancy_{kind}_{suffix}")
            fn.argtypes = [_I] * 3 + [ctypes.POINTER(_I)] * 2
            fn.restype = ctypes.c_int
    return lib


def library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        _lib = bind(ctypes.CDLL(str(build_library())))
    return _lib


def _suffix(name: str, dtype: torch.dtype) -> str:
    suffix = _SUFFIX.get(dtype)
    if suffix is None:
        raise TypeError(f"{name}: kernels take float32 or float64, not {dtype}")
    return suffix


def _call(lib, name: str, dtype: torch.dtype, stream: int, ptrs, ints) -> None:
    err = getattr(lib, f"iq_{name}_{_suffix(name, dtype)}")(*ptrs, *ints,
                                                             stream)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")
    LAUNCHES[name] += 1


def _ptr(t) -> int | None:
    return None if t is None else t.data_ptr()


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


def pass_occupancy(kind: str, dtype: torch.dtype, C: int, S: int,
                   Pp: int) -> tuple[int, int]:
    """(resident blocks per SM, dynamic shared memory bytes per block) of
    the kernel instance a pass of ``kind`` (PASS_KINDS) launches for C
    categories of S states and Pp patterns, on the current card (S > 64:
    the wide instance)."""
    blocks, shm = _I(), _I()
    err = getattr(library(),
                  f"iq_pass_occupancy_{kind}_{_suffix(kind, dtype)}")(
        C, S, Pp, ctypes.byref(blocks), ctypes.byref(shm))
    if err != 0:
        raise RuntimeError(f"{kind} occupancy query failed: CUDA error {err}")
    return blocks.value, shm.value


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


def child_rows(tip, all_, src):
    """Down partials [..., C, S, Pp] of unified rows ``src`` (int64): a leaf's
    from ``tip`` (broadcast over categories), an internal node's from
    ``all_``. The tip rows of ``all_`` are never read, as in the kernels."""
    L = tip.shape[0]
    leaf = (src < L)[..., None, None, None]
    return torch.where(leaf, tip[src.clamp(max=L - 1)][..., None, :, :],
                       all_[src.clamp(min=L)])


def edge_sources(child_src, child_edge, n_edges: int):
    """Unified row of each edge's child side [n_edges] int64 (edge 0 is leaf
    0's, folded into the root)."""
    src = torch.zeros(n_edges, dtype=torch.int64, device=child_src.device)
    src[child_edge.flatten().long()] = child_src.flatten().long()
    return src


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
def down_pass(P, tip, all_, sc, child_src, child_edge, step_node,
              sitelp=None) -> None:
    """The whole postorder pass, in place: for every level step of
    ``step_node`` in order and every node of it (pad slots = n_int are
    skipped), write its partial and scale count into the unified buffers
    ``all_`` [L+n_int, C, S, Pp] and ``sc`` [L+n_int, Pp] (tip rows of ``sc``
    zero). Tip rows of ``all_`` are neither read nor written (tips come from
    ``tip``). With ``sitelp = (root_freqs, cat_weight, log_ptn_invar, lp)``
    the same launch then writes the site log-likelihoods into ``lp`` [Pp]
    (the epilogue; root_sitelp_plain).

    P [E, C, S, S]; tip [L, S, Pp]; child_src/child_edge [n_int, 2] int32;
    step_node [n_steps, G] int32. Contract of pruning._down_pass_xla.
    """
    if not all_.is_cuda:
        down_pass_plain(P, tip, all_, sc, child_src, child_edge, step_node,
                        sitelp)
        return
    stream = _check_cuda("down_pass", (P, tip, all_) + tuple(sitelp or ()),
                         (sc, child_src, child_edge, step_node))
    launch_down_pass(library(), stream, P, tip, all_, sc, child_src,
                     child_edge, step_node, sitelp)


def launch_down_pass(lib, stream, P, tip, all_, sc, child_src, child_edge,
                     step_node, sitelp=None) -> None:
    L, S, Pp = tip.shape
    n_steps, G = step_node.shape
    if sitelp is not None and any(t.numel() != Pp for t in sitelp[2:]):
        raise ValueError(f"down_pass: log_ptn_invar and lp must hold {Pp} "
                         f"values")
    _call(lib, "down_pass", all_.dtype, stream,
          [t.data_ptr() for t in (P, tip, all_, sc, child_src, child_edge,
                                  step_node)]
          + [_ptr(t) for t in (sitelp or (None,) * 4)],
          [n_steps, G, child_src.shape[0], L, P.shape[1], S, Pp])
    if sitelp is not None:
        LAUNCHES["sitelp"] += 1


def down_pass_plain(P, tip, all_, sc, child_src, child_edge, step_node,
                    sitelp=None) -> None:
    for row in step_node:
        down_step_plain(P, tip, all_, sc, child_src, child_edge, row)
    if sitelp is not None:
        root_freqs, cat_weight, log_ptn_invar, lp = sitelp
        lp.copy_(root_sitelp_plain(P, tip, all_, sc, all_.shape[0] - 1,
                                   root_freqs, cat_weight, log_ptn_invar))


def down_step_plain(P, tip, all_, sc, child_src, child_edge, step_row) -> None:
    """One level step of the down pass (the kernel's step body)."""
    L = tip.shape[0]
    thresh, factor, _ = scaling_consts(all_.dtype)
    nid = step_row[step_row < child_src.shape[0]].long()
    if nid.numel() == 0:
        return
    src = child_src[nid].long()                       # [g, 2]
    msg = apply_P(P[child_edge[nid].long()], child_rows(tip, all_, src))
    prod, cnt = _rescale(msg[:, 0] * msg[:, 1], sc[src[:, 0]] + sc[src[:, 1]],
                         thresh, factor)
    all_[L + nid] = prod
    sc[L + nid] = cnt


def root_sitelp_plain(P, tip, all_, sc, root_row, root_freqs, cat_weight,
                      log_ptn_invar):
    """Site log-likelihoods lp [Pp] (the down pass's epilogue): fold leaf
    0's message P[0]·tip[0] into the root partial ``all_[root_row]``, weight
    by cat_weight x root_freqs, log, subtract the scale, logaddexp the
    invariant-site term."""
    m0 = apply_P(P[0], tip[0])                        # [C, S, Pp]
    return root_lp(all_[root_row] * m0, sc[root_row], root_freqs,
                   cat_weight, log_ptn_invar)


# ---------------------------------------------------------------- H2
def up_pass(P, tip, all_, dsc, up, upsc, E, esc, child_src, child_edge,
            step_node) -> None:
    """The whole pre-order sweep, in place: for the level steps of
    ``step_node`` in reverse order, every node of a step and child slot k,
    E[edge_k] = UP(node) x msg(sibling), rescaled, and for internal
    children UP(child) = P_k^T E[edge_k], rescaled. UP of the root and E of
    edge 0 must be set before (root_init_plain).

    all_/dsc: down partials and scales (unified; tip rows of all_ are not
    read); up/upsc [n_int, ...]; E/esc [n_edges, ...]. Contract of
    pruning._up_pass_xla.
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
    msg = apply_P(Pe, child_rows(tip, all_, src))
    # E for slot k = UP(node) * message of the other slot
    Es, Esc = _rescale(up[nid][:, None] * msg.flip(1),
                       upsc[nid][:, None] + dsc[src].flip(1), thresh, factor)
    E[eid] = Es
    esc[eid] = Esc
    upc, upc_sc = _rescale(apply_PT(Pe, Es), Esc, thresh, factor)
    is_int = src >= L
    up[src[is_int] - L] = upc[is_int]
    upsc[src[is_int] - L] = upc_sc[is_int]


def root_init_plain(P, tip, all_, dsc, up, upsc, E, esc, root_freqs) -> None:
    """The sweep's start, in place: UP(root) = pi * (P_0 tip_0) with scale 0
    and E of edge 0 = pi * down(root) with the root's scale (leaf 0's edge
    is folded into the root)."""
    n_int = up.shape[0]
    root = all_.shape[0] - 1
    up[n_int - 1] = root_freqs[:, :, None] * apply_P(P[0], tip[0])
    upsc[n_int - 1] = 0
    E[0] = root_freqs[:, :, None] * all_[root]
    esc[0] = dsc[root]


# ---------------------------------------------------------------- H3
def theta_pass(P, tip, all_, dsc, up, upsc, theta, tsc, child_src, child_edge,
               step_node, U, V, root_freqs) -> None:
    """The pre-order sweep with theta, in place: UP(root) and theta of edge
    0 first, then for the level steps in reverse order, every node of a step
    and child slot k, E[edge_k] as in up_pass and from it

        theta[e, c, k, p] = (sum_x E[e,c,x,p] U[c,x,k])
                            (sum_y V[c,k,y] D[src_e,c,y,p])

    with scale esc[e] + dsc[src_e] (D: the child's down partial, from
    ``tip`` for a leaf), and UP(child) for internal children. E itself is
    not kept. up/upsc [n_int, ...] are written whole; theta/tsc
    [n_edges, ...]; U/V [C, S, S] per-category eigenvectors; root_freqs
    [C, S]. Contract of pallas_pruning2.stream_theta_pass.
    """
    if not up.is_cuda:
        theta_pass_plain(P, tip, all_, dsc, up, upsc, theta, tsc, child_src,
                         child_edge, step_node, U, V, root_freqs)
        return
    stream = _check_cuda("theta_pass",
                         (P, tip, all_, up, theta, U, V, root_freqs),
                         (dsc, upsc, tsc, child_src, child_edge, step_node))
    launch_theta_pass(library(), stream, P, tip, all_, dsc, up, upsc, theta,
                      tsc, child_src, child_edge, step_node, U, V, root_freqs)


def launch_theta_pass(lib, stream, P, tip, all_, dsc, up, upsc, theta, tsc,
                      child_src, child_edge, step_node, U, V,
                      root_freqs) -> None:
    L, S, Pp = tip.shape
    C = P.shape[1]
    n_steps, G = step_node.shape
    _call(lib, "theta_pass", up.dtype, stream,
          [t.data_ptr() for t in (P, tip, all_, dsc, up, upsc, theta, tsc,
                                  U, V, root_freqs, child_src, child_edge,
                                  step_node)],
          [n_steps, G, child_src.shape[0], L, C, S, Pp])


def theta_pass_plain(P, tip, all_, dsc, up, upsc, theta, tsc, child_src,
                     child_edge, step_node, U, V, root_freqs) -> None:
    E, esc = torch.empty_like(theta), torch.empty_like(tsc)
    root_init_plain(P, tip, all_, dsc, up, upsc, E, esc, root_freqs)
    up_pass_plain(P, tip, all_, dsc, up, upsc, E, esc, child_src, child_edge,
                  step_node)
    src = edge_sources(child_src, child_edge, theta.shape[0])
    th, ts = edge_theta_plain(E, esc, child_rows(tip, all_, src), dsc[src],
                              U, V)
    theta.copy_(th)
    tsc.copy_(ts)


def edge_theta_plain(E, esc, D, Dsc, U, V):
    """theta[e, c, k, p] = (sum_x E[e,c,x,p] U[c,x,k]) (sum_y V[c,k,y]
    D[e,c,y,p]) and its scale esc + Dsc, for each edge's E [E, C, S, Pp] and
    child-side down partial D (scale Dsc). Returns (theta, scale)."""
    return apply_PT(U, E) * apply_P(V, D), esc + Dsc
