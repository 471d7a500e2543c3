"""ModelPack: the device-array bundle describing (substitution model x rate
heterogeneity x mixture) to the likelihood kernels.

The kernels are deliberately model-agnostic: they only see
  eigvals[M,S], U[M,S,S], V[M,S,S]   per-mixture-class eigensystems
  cat_rate[C], cat_weight[C]         per-category rates/weights
  cat_mix[C]                          category -> mixture class index
  root_freqs[C,S]                     per-category stationary frequencies
  tip_table[ncodes,S]                 leaf indicator rows (ambiguity-aware)
  log_ptn_invar[P]                    log invariant-site likelihood (+I)
This single family covers plain models (+G/+I/+R collapse to C categories of
one mixture class) and full mixtures (C = mixture x rate classes), matching
the reference's fused mixture/rate kernels (model/modelfactory.cpp:136
fused_mix_rate, tree/phylokernelmixture.h).

Copied from iqtree2_tpu/model/pack.py: the port keeps its own host
modules and imports nothing of the JAX package.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from iqtree2_tpu_torch.data.alignment import Alignment
from iqtree2_tpu_torch.model.rates import RateModel
from iqtree2_tpu_torch.model.subst import SubstModel


@dataclasses.dataclass
class ModelPack:
    eigvals: np.ndarray     # [M, S]
    U: np.ndarray           # [M, S, S]
    V: np.ndarray           # [M, S, S]
    W: np.ndarray | None    # [M, S, S] orthonormal symmetrized eigvecs
    sqrt_freqs: np.ndarray | None  # [M, S]
    Q: np.ndarray | None    # [M, S, S] nonreversible rate matrices
    cat_rate: np.ndarray    # [C]
    cat_weight: np.ndarray  # [C]
    cat_mix: np.ndarray     # [C] int32
    root_freqs: np.ndarray  # [C, S]
    tip_table: np.ndarray   # [ncodes, S]
    log_ptn_invar: np.ndarray  # [P] (log of invariant-site lh; -inf if none)
    p_invar: float
    mean_freqs: np.ndarray  # [S] mixture-weighted stationary freqs

    @property
    def num_states(self) -> int:
        return self.eigvals.shape[1]

    @property
    def num_categories(self) -> int:
        return self.cat_rate.shape[0]

    def astype(self, dtype) -> "ModelPack":
        c = lambda a: np.asarray(a, dtype=dtype)
        return ModelPack(
            eigvals=c(self.eigvals), U=c(self.U), V=c(self.V),
            W=None if self.W is None else c(self.W),
            sqrt_freqs=None if self.sqrt_freqs is None
            else c(self.sqrt_freqs),
            Q=None if self.Q is None else c(self.Q),
            cat_rate=c(self.cat_rate), cat_weight=c(self.cat_weight),
            cat_mix=self.cat_mix, root_freqs=c(self.root_freqs),
            tip_table=c(self.tip_table),
            log_ptn_invar=c(self.log_ptn_invar),
            p_invar=self.p_invar, mean_freqs=c(self.mean_freqs))


def build_model_pack(aln: Alignment, model: SubstModel,
                     rates: RateModel) -> ModelPack:
    """Assemble kernel arrays from host model objects (cold path, float64)."""
    eig = model.get_eigensystem()
    M = eig.num_mixtures
    S = eig.num_states
    r = rates.category_rates()      # [Cr]
    w = rates.category_weights()    # [Cr]
    Cr = len(r)

    if getattr(model, "fused_rates", False) and Cr == M:
        # fused mixture x rate: class k pairs only with rate category k
        # (reference: fused_mix_rate, model/modelfactory.cpp:136 — LG4M *G4,
        # LG4X *R4)
        cat_rate = np.asarray(r)
        cat_weight = np.asarray(w) * eig.mix_weights
        cat_weight = cat_weight / cat_weight.sum()
        cat_mix = np.arange(M, dtype=np.int32)
    else:
        # cross product of mixture x rate classes on one category axis
        cat_rate = np.tile(r, M)                           # [M*Cr]
        cat_weight = np.concatenate(
            [w * eig.mix_weights[m] for m in range(M)])
        cat_mix = np.repeat(np.arange(M, dtype=np.int32), Cr)
    root_freqs = eig.freqs[cat_mix]                        # [C, S]

    # invariant-site likelihood per pattern: p_inv * sum_x pi_x * const(p,x)
    p_inv = rates.p_invar
    mean_freqs = (eig.freqs * eig.mix_weights[:, None]).sum(0)
    P = aln.num_patterns
    if p_inv > 0:
        const_mask = aln.const_state_mask()                # [P, S]
        inv = p_inv * const_mask @ mean_freqs
        with np.errstate(divide="ignore"):
            log_inv = np.log(inv)
    else:
        log_inv = np.full(P, -np.inf)

    tip_table = aln.seqtype.tip_table.copy()
    if hasattr(model, "transform_tip_table"):
        # sequencing-error models (+E) reshape the tip likelihoods
        # (model/modeldnaerror.cpp:89)
        tip_table = model.transform_tip_table(tip_table)

    return ModelPack(
        eigvals=eig.eigvals, U=eig.U, V=eig.V,
        W=eig.W,
        sqrt_freqs=None if eig.W is None else np.sqrt(
            np.maximum(eig.freqs, 1e-300)),
        Q=eig.Q,
        cat_rate=cat_rate, cat_weight=cat_weight, cat_mix=cat_mix,
        root_freqs=root_freqs,
        tip_table=tip_table,
        log_ptn_invar=log_inv, p_invar=float(p_inv),
        mean_freqs=mean_freqs)
