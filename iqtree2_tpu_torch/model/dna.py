"""Named DNA substitution models.

Each named model is a GTR with equality constraints on the six
exchangeabilities, encoded as a 6-digit string over rate order
(AC,AG,AT,CG,CT,GT) — the same scheme as the reference
(model/modeldna.cpp:42-160), where equal digits share one parameter and the
class containing GT is fixed at rate 1.

Copied from iqtree2_tpu/model/dna.py: the port keeps its own host
modules and imports nothing of the JAX package.
"""

from __future__ import annotations

import numpy as np

from iqtree2_tpu_torch.model.subst import GTRModel

# name -> (canonical name, rate constraint code, default freq type)
DNA_MODELS: dict[str, tuple[str, str, str]] = {}


def _reg(names, canonical, code, freq):
    for n in names:
        DNA_MODELS[n.upper()] = (canonical, code, freq)


_reg(["JC", "JC69"], "JC", "000000", "equal")
_reg(["F81"], "F81", "000000", "empirical")
_reg(["K2P", "K80"], "K2P", "010010", "equal")
_reg(["HKY", "HKY85"], "HKY", "010010", "empirical")
_reg(["K3P", "K81", "TPM1"], "K3P", "012210", "equal")
_reg(["K81UF", "K81U", "K3PU", "K3PUF", "TPM1UF", "TPM1U"], "K3Pu",
     "012210", "empirical")
_reg(["TN", "TRN", "TN93"], "TN", "010020", "empirical")
_reg(["TNEF", "TRNEF", "TNE", "TRNE"], "TNe", "010020", "equal")
_reg(["TPM2"], "TPM2", "121020", "equal")
_reg(["TPM2U", "TPM2UF"], "TPM2u", "121020", "empirical")
_reg(["TPM3"], "TPM3", "120120", "equal")
_reg(["TPM3U", "TPM3UF"], "TPM3u", "120120", "empirical")
_reg(["TIM", "TIM1"], "TIM", "012230", "empirical")
_reg(["TIMEF", "TIME", "TIM1EF", "TIM1E"], "TIMe", "012230", "equal")
_reg(["TIM2"], "TIM2", "121030", "empirical")
_reg(["TIM2EF", "TIM2E"], "TIM2e", "121030", "equal")
_reg(["TIM3"], "TIM3", "120130", "empirical")
_reg(["TIM3EF", "TIM3E"], "TIM3e", "120130", "equal")
_reg(["TVM"], "TVM", "412310", "empirical")
_reg(["TVMEF", "TVME"], "TVMe", "412310", "equal")
_reg(["SYM"], "SYM", "123450", "equal")
_reg(["GTR", "REV"], "GTR", "123450", "empirical")


def make_dna_model(name: str, freqs: np.ndarray | None = None,
                   freq_type: str | None = None,
                   rate_params: np.ndarray | None = None) -> GTRModel:
    """Instantiate a named DNA model (or a raw 6-digit code)."""
    key = name.upper()
    if key in DNA_MODELS:
        canonical, code, def_freq = DNA_MODELS[key]
    elif len(key) == 6 and key.isdigit():
        canonical, code, def_freq = name, key, "estimate"
    else:
        raise ValueError(f"unknown DNA model {name!r}")
    ft = freq_type or def_freq
    if ft == "equal":
        freqs = np.full(4, 0.25)
    m = GTRModel(4, freqs=freqs, freq_type=ft, name=canonical,
                 rate_constraints=code)
    if rate_params is not None:
        m.set_rate_params(np.asarray(rate_params, dtype=np.float64))
    return m


def is_dna_model_name(name: str) -> bool:
    key = name.upper()
    return key in DNA_MODELS or (len(key) == 6 and key.isdigit())
