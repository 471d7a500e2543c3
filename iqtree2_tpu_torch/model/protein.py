"""Empirical amino-acid substitution models (LG, WAG, JTT, Q.*, mt*, ...).

The exchangeability/frequency constants are published scientific data,
extracted into model/data/prot_models.npz from the reference's embedded
NEXUS block (model/modelprotein.cpp:31 builtin_prot_models). Reversible
models store the lower-triangle exchangeabilities + frequencies; NQ.* models
store a full nonreversible Q.

Copied from iqtree2_tpu/model/protein.py: the port keeps its own host
modules and imports nothing of the JAX package.
"""

from __future__ import annotations

from functools import lru_cache
from pathlib import Path

import numpy as np

from iqtree2_tpu_torch.model.subst import (Eigensystem, GTRModel, SubstModel,
                                           eigen_general)

_DATA = Path(__file__).parent / "data" / "prot_models.npz"


@lru_cache(maxsize=1)
def _load():
    return np.load(_DATA)


@lru_cache(maxsize=1)
def available_protein_models() -> list[str]:
    names = set()
    for k in _load().files:
        names.add(k.rsplit("_", 1)[0])
    return sorted(names)


def is_protein_model_name(name: str) -> bool:
    up = name.upper()
    models = {m.upper() for m in available_protein_models()}
    return up in models or up in ("GTR20", "POISSON", "NONREV")


def make_protein_model(name: str, freqs: np.ndarray | None = None,
                       freq_type: str | None = None) -> SubstModel:
    """Instantiate an empirical AA model. freq_type '+F' (empirical counts)
    replaces the model's own frequencies."""
    data = _load()
    key = None
    for cand in available_protein_models():
        if cand.upper() == name.upper():
            key = cand
            break
    if key is None:
        if name.upper() == "GTR20":
            return GTRModel(20, freq_type=freq_type or "estimate",
                            name="GTR20")
        raise ValueError(f"unknown protein model {name!r}")
    if f"{key}_q" in data.files:
        Q = data[f"{key}_q"]
        f = data[f"{key}_freqs"]
        return NonRevProteinModel(key, Q, f)
    R = data[f"{key}_rates"]
    f0 = data[f"{key}_freqs"]
    ft = freq_type or "model"
    if ft in ("model", "user") and freqs is None:
        freqs = f0
    elif ft == "equal":
        freqs = np.full(20, 0.05)
    iu = np.triu_indices(20, 1)
    m = GTRModel(20, exch_rates=R[iu], freqs=freqs, freq_type=ft,
                 name=key, fixed_rates=True)
    return m


class NonRevProteinModel(SubstModel):
    """Nonreversible empirical model (NQ.*): full Q given as data.

    Complex eigensystem handled by splitting into real arithmetic on device
    is future work; for now P(t) uses the real part of U e^{Lt} V (NQ.*
    matrices in practice have eigenvalues with tiny imaginary parts).
    """

    def __init__(self, name: str, Q: np.ndarray, freqs: np.ndarray):
        self.name = name
        self.num_states = 20
        # normalize Q rows and mean rate like the reversible path
        Q = Q.copy()
        np.fill_diagonal(Q, 0.0)
        np.fill_diagonal(Q, -Q.sum(axis=1))
        mu = -(freqs * np.diag(Q)).sum()
        self.Q = Q / mu
        self.freqs = freqs
        self.freq_type = "model"

    def is_reversible(self) -> bool:
        return False

    def get_eigensystem(self) -> Eigensystem:
        w, U, V = eigen_general(self.Q)
        # Q is carried for the exact nonreversible device path (expm);
        # the real parts of U/V are kept only for host-side reporting.
        return Eigensystem(eigvals=np.real(w)[None],
                           U=np.real(U)[None], V=np.real(V)[None],
                           freqs=self.freqs[None],
                           mix_weights=np.ones(1), Q=self.Q[None])

    def num_free_params(self) -> int:
        return 0
