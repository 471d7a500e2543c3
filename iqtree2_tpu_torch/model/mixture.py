"""Mixture substitution models: generic MIX{...}, profile mixtures
(C10-C60, CF4), multi-matrix mixtures (LG4M, LG4X, EX2/EX3/EHO/UL2/UL3,
EX_EHO).

Reference analog: ModelMixture (model/modelmixture.cpp) — a mixture is a
list of component ModelMarkov's with weights and per-component rate
multipliers; the likelihood kernels see the fused (mixture x rate) category
axis (model/modelfactory.cpp:136 fused_mix_rate). Here the kernels already
take per-category eigensystems (ModelPack cat_mix), so a mixture is just an
Eigensystem with M > 1 classes; component rate multipliers fold into the
eigenvalues.

Numeric component data (profiles/matrices/weights) extracted from the
published model definitions via tools/extract_mixtures.py into
data/mixture_models.npz (Le, Gascuel & Lartillot 2008; Le, Dang & Gascuel
2012; Quang, Gascuel & Lartillot 2008).

Copied from iqtree2_tpu/model/mixture.py with its data files
(model/data/mixture_models.npz, mixture_defs.json, byte for byte): the port
keeps its own host modules and imports nothing of the JAX package.
"""

from __future__ import annotations

import functools
import json
from pathlib import Path

import numpy as np

from iqtree2_tpu_torch.model.subst import (Eigensystem, SubstModel,
                                           build_gtr_rate_matrix,
                                           eigen_reversible)

DATA_DIR = Path(__file__).parent / "data"


@functools.lru_cache(maxsize=1)
def _mix_data():
    npz = np.load(DATA_DIR / "mixture_models.npz")
    defs = json.loads((DATA_DIR / "mixture_defs.json").read_text())
    return npz, defs


def profile_names(prefix: str, n: int) -> list[str]:
    return [f"{prefix}pi{i + 1}" for i in range(n)]


class MixtureModel(SubstModel):
    """A mixture over (exchangeability matrix, frequency profile) classes.

    components: list of (exch_rates [nr], freqs [S], rate_multiplier).
    weights: [M] class weights (fixed or optimizable).
    """

    def __init__(self, components, weights, name: str,
                 optimize_weights: bool = False, fused_rates: bool = False,
                 num_states: int = 20):
        self.num_states = num_states
        self.name = name
        self.components = components
        w = np.asarray(weights, np.float64)
        self.weights = w / w.sum()
        self.optimize_weights = optimize_weights
        # fused_rates: class k pairs only with rate category k (LG4M/LG4X)
        self.fused_rates = fused_rates
        self.freq_type = "mixture"

    @property
    def freqs(self) -> np.ndarray:
        """Mixture-weighted mean frequencies (for reports/simulation)."""
        f = np.stack([c[1] for c in self.components])
        return (self.weights[:, None] * f).sum(0)

    def get_eigensystem(self) -> Eigensystem:
        eigvals, U, V, W, F = [], [], [], [], []
        for (exch, freqs, rate) in self.components:
            f = np.asarray(freqs, np.float64)
            f = np.maximum(f, 1e-10)
            f = f / f.sum()
            Q = build_gtr_rate_matrix(np.asarray(exch, np.float64), f)
            w_, U_, V_, W_ = eigen_reversible(Q, f)
            eigvals.append(w_ * rate)
            U.append(U_)
            V.append(V_)
            W.append(W_)
            F.append(f)
        return Eigensystem(eigvals=np.stack(eigvals), U=np.stack(U),
                           V=np.stack(V), freqs=np.stack(F),
                           mix_weights=self.weights.copy(),
                           W=np.stack(W))

    # --------------------------------------------------- optimizable weights
    def get_params(self) -> np.ndarray:
        if not self.optimize_weights or len(self.weights) < 2:
            return np.zeros(0)
        return self.weights[:-1] / self.weights[-1]

    def set_params(self, x: np.ndarray) -> None:
        if not self.optimize_weights or len(x) == 0:
            return
        raw = np.concatenate([x, [1.0]])
        self.weights = raw / raw.sum()

    def param_bounds(self):
        n = len(self.get_params())
        return np.full(n, 1e-4), np.full(n, 1000.0)

    def num_free_params(self) -> int:
        return len(self.get_params())


# ------------------------------------------------------------- constructors
def _matrix_component(name: str) -> tuple[np.ndarray, np.ndarray]:
    """(exch [190], freqs [20]) of a stored full matrix component."""
    npz, _ = _mix_data()
    vals = npz[f"matrix_{name}"]
    return vals[:190], vals[190:]


def _lower_to_upper_exch(low: np.ndarray, S: int = 20) -> np.ndarray:
    """Stored matrices are row-major lower-triangle (row i: j<i);
    build_gtr_rate_matrix wants the upper-triangle row-major order."""
    M = np.zeros((S, S))
    k = 0
    for i in range(1, S):
        for j in range(i):
            M[j, i] = low[k]
            k += 1
    iu = np.triu_indices(S, 1)
    return M[iu]


def make_mixture(name: str, aln=None, base_exch: np.ndarray | None = None
                 ) -> MixtureModel:
    """Build a named built-in mixture (C10..C60, EX2, EX3, EHO, UL2, UL3,
    EX_EHO, LG4M, LG4X, CF4); base_exch optionally overrides the profile
    mixtures' Poisson exchangeabilities (e.g. LG+C20)."""
    npz, defs = _mix_data()
    # case-blind: the definitions file spells C10Opt and C20Opt (the JAX
    # package looks up name.upper() and so refuses them, ROADMAP C14)
    key = {k.upper(): k for k in defs}.get(name.upper())
    if key is None:
        raise ValueError(f"unknown mixture model {name}")
    d = defs[key]
    comps = []
    weights = []
    S = 20
    nr = S * (S - 1) // 2
    if d["kind"] == "FMIX":
        exch = base_exch if base_exch is not None else np.ones(nr)
        for c in d["components"]:
            if c["name"] == "empirical":
                if aln is None:
                    raise ValueError(f"{name} needs an alignment for the "
                                     "empirical class")
                f = aln.state_frequencies()
            else:
                f = npz[f"freq_{c['name']}"]
            comps.append((exch, f, c["rate"]))
            weights.append(c["weight"] if c["weight"] is not None
                           else 1.0 / len(d["components"]))
    else:  # MIX of full matrices
        for c in d["components"]:
            low, f = _matrix_component(c["name"])
            comps.append((_lower_to_upper_exch(low), f, c["rate"]))
            weights.append(c["weight"] if c["weight"] is not None
                           else 1.0 / len(d["components"]))
    optimize_w = all(c["weight"] is None for c in d["components"])
    return MixtureModel(comps, weights, name=key,
                        optimize_weights=optimize_w,
                        fused_rates=d["suffix"] in ("G4", "R4"))


def make_generic_mix(component_specs: list[str], aln) -> MixtureModel:
    """MIX{m1,m2,...}: each component is a plain model string resolved by
    the factory; weights optimized."""
    from iqtree2_tpu_torch.model.factory import build_model
    comps = []
    for spec in component_specs:
        m, _, _ = build_model(spec, aln)
        if not hasattr(m, "exch_rates"):
            raise ValueError(f"MIX component {spec!r} must be a reversible "
                             "matrix model")
        comps.append((m.exch_rates.copy(), m.freqs.copy(), 1.0))
    M = len(comps)
    return MixtureModel(comps, np.full(M, 1.0 / M),
                        name="MIX{" + ",".join(component_specs) + "}",
                        optimize_weights=True,
                        num_states=comps[0][1].shape[0])
