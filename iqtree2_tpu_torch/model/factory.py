"""Model-string parser: "GTR+F+I+G4" -> (SubstModel, RateModel).

Reference analog: ModelFactory (model/modelfactory.cpp:151) which parses the
model specification into substitution-model + rate-heterogeneity objects.
Grammar the port runs:

  NAME[{p1,p2,...}] [+F|+FO|+FQ|+FC|+FU{...}|+FEQ|+F1X4|+F3X4] [+I[{p}]]
       [+G[n][{a}]] [+R[n][{r1,w1,...}]] [+E|+EA|+EC|+EG|+ET[{eps}]] [+ASC]
       [+P[N][{theta}]] [+H[k][{w1,...}]] [+T[{w1,...}]]
       and MIX{m1,...}, named mixtures (C10-C60, CF4, LG4M, LG4X, EX2, ...)
       and base+profile (LG+C20, WAG+C60, ...)

Copied from iqtree2_tpu/model/factory.py with the branches the port runs,
in the JAX order: the mixture models of model/mixture.py, the YAML models
of --mdef (io/yamlmodels.py), the codon models (model/codon.py: GY, MG,
MGK, ... and KOSI07/ECMREST/SCHN05; every model on CODON data, so MK there
is GY94 under another name, as in the JAX package), the nonreversible
UNREST/NONREV (model/nonrev.py) and, on DNA, the 37 Lie-Markov models
(model/liemarkov.py) unless the name is a DNA model's, the named DNA and
protein models (and the MK/ORDERED forms of GTR), and on DNA the +E
sequencing-error wrapper (model/seqerror.py) and PoMo +P{N}
(model/pomo.py), under uniform, +I, +G, +I+G, +R, +I+R and +H{k}
(model/heterotachy.py, alone) rates, with +T (tree mixtures) and +ASC
as flags. The JAX package accepts +E or +P beside a mixture (MIX{...}
too), a YAML, a codon, a nonreversible or a Lie-Markov model and ignores
it (its branches return before the wrappers; +P replaces the +E model):
the port refuses that with a SystemExit, and +H beside a mixture or a
nonreversible model too. The port keeps its own host modules and imports
nothing of the JAX package.
"""

from __future__ import annotations

import re

import numpy as np

from iqtree2_tpu_torch.data.alignment import Alignment
from iqtree2_tpu_torch.io import yamlmodels
from iqtree2_tpu_torch.model import dna, protein
from iqtree2_tpu_torch.model.codon import make_codon_model
from iqtree2_tpu_torch.model.heterotachy import RateHeterotachy
from iqtree2_tpu_torch.model.liemarkov import (LieMarkovModel,
                                               is_lie_markov_name)
from iqtree2_tpu_torch.model.mixture import make_generic_mix, make_mixture
from iqtree2_tpu_torch.model.nonrev import UnrestModel
from iqtree2_tpu_torch.model.pomo import PoMoModel
from iqtree2_tpu_torch.model.rates import (RateFree, RateFreeInvar, RateGamma,
                                           RateGammaInvar, RateInvar,
                                           RateModel)
from iqtree2_tpu_torch.model.seqerror import DNAErrorModel
from iqtree2_tpu_torch.model.subst import GTRModel, SubstModel


class ModelSpec:
    def __init__(self, base: str, base_params, freq_type, freq_params,
                 rate_terms, other_terms=None):
        self.base = base
        self.base_params = base_params
        self.freq_type = freq_type
        self.freq_params = freq_params
        self.rate_terms = rate_terms  # list of (kind, ncat, params)
        self.other_terms = other_terms or []  # e.g. mixture suffixes +C20


_TERM_RE = re.compile(r"\+([A-Za-z]+)(\d*)(\{[^}]*\})?")


def parse_model_string(s: str) -> ModelSpec:
    s = s.strip()
    # base name with optional {params}
    m = re.match(r"^([A-Za-z0-9._]+)(\{[^}]*\})?", s)
    if not m:
        raise ValueError(f"cannot parse model string {s!r}")
    base = m.group(1)
    base_params = _parse_braces(m.group(2))
    rest = s[m.end():]

    freq_type = None
    freq_params = None
    rate_terms: list[tuple[str, int, list[float]]] = []
    other_terms: list[str] = []
    for t in _TERM_RE.finditer(rest):
        kind = t.group(1).upper()
        num = int(t.group(2)) if t.group(2) else None
        params = _parse_braces(t.group(3))
        full = f"{kind}{t.group(2) or ''}"
        if full in ("C10", "C20", "C30", "C40", "C50", "C60", "CF4",
                    "EX2", "EX3", "EHO", "UL2", "UL3", "EX_EHO",
                    "LG4M", "LG4X"):
            other_terms.append(full)
            continue
        if kind == "F" and num in (1, 3):
            freq_type = f"F{num}X4"   # codon positional frequencies
        elif kind in ("F", "FO", "FQ", "FEQ", "FU", "FC"):
            freq_type = {"F": "empirical", "FO": "estimate", "FQ": "equal",
                         "FEQ": "equal", "FU": "user",
                         "FC": "empirical"}[kind]
            freq_params = params
        elif kind == "I":
            rate_terms.append(("I", 1, params))
        elif kind == "G":
            rate_terms.append(("G", num or 4, params))
        elif kind == "R":
            rate_terms.append(("R", num or 4, params))
        elif kind in ("E", "EA", "EC", "EG", "ET"):
            rate_terms.append((kind, 1, params))  # sequencing error
        elif kind == "ASC":
            rate_terms.append(("ASC", 1, params))
        elif kind == "H":
            rate_terms.append(("H", num or 4, params))
        elif kind == "T":
            rate_terms.append(("T", num or 0, params))  # tree mixture
        elif kind == "P":
            rate_terms.append(("P", num or 9, params))  # PoMo
        else:
            raise ValueError(f"unsupported model term +{kind} in {s!r}")
    return ModelSpec(base, base_params, freq_type, freq_params, rate_terms,
                     other_terms)


def _parse_braces(s: str | None) -> list[float] | None:
    if not s:
        return None
    inner = s.strip()[1:-1]
    if not inner:
        return []
    return [float(x) for x in inner.split(",")]


MIXTURE_NAMES = {"C10", "C20", "C30", "C40", "C50", "C60", "EX2", "EX3",
                 "EHO", "UL2", "UL3", "EX_EHO", "LG4M", "LG4X", "LG4",
                 "CF4", "C10OPT", "C20OPT"}
CODON_NAMES = ("GY", "MG", "MGK", "GY1KTS", "GY1KTV", "GY2K")
# the rate terms of the +E sequencing-error models
_SEQERR_TERMS = ("E", "EA", "EC", "EG", "ET")


def _refuse_seqerror(spec_str: str, spec: ModelSpec, what: str) -> None:
    """SystemExit for +E beside ``what`` (a mixture, a YAML or a codon
    model): the JAX factory's branches for those return before
    _maybe_wrap_seqerror, so it fits the model without the error term."""
    if {k for (k, _, _) in spec.rate_terms} & set(_SEQERR_TERMS):
        raise SystemExit(f"-m {spec_str}: +E (the sequencing-error model) "
                         f"with {what} is ignored by the JAX package (it "
                         f"wraps DNA models only); drop the +E term")


def _refuse_pomo(spec_str: str, spec: ModelSpec, what: str) -> None:
    """SystemExit for +P beside ``what``: the JAX factory's branches for
    those return before _maybe_pomo, so it fits the model without PoMo."""
    if any(k == "P" for (k, _, _) in spec.rate_terms):
        raise SystemExit(f"-m {spec_str}: +P (PoMo) with {what} is ignored "
                         f"by the JAX package (it builds PoMo on a named DNA "
                         f"model only); drop the +P term")


def _refuse_nonrev_mixlen(spec_str: str, model, extras: dict) -> None:
    """SystemExit for +H beside a nonreversible model: the JAX package's
    per-class Newton reads the eigensystem, which for such a model keeps
    only the real parts of a complex one (ROADMAP C18)."""
    if extras.get("mixlen") and not model.is_reversible():
        raise SystemExit(f"-m {spec_str}: +H (per-class branch lengths) "
                         f"with a nonreversible model runs the JAX "
                         f"package's eigenbasis Newton on a real-part "
                         f"eigensystem (ROADMAP C18); not run here")


def build_model(spec_str: str, aln: Alignment) -> tuple[SubstModel, RateModel,
                                                        dict]:
    """Instantiate model + rates for an alignment. Returns (model, rates,
    extras) where extras carries the +ASC and +T flags."""
    s = spec_str.strip()
    # generic mixture MIX{m1,m2,...}[+rate terms]
    if s.upper().startswith("MIX{"):
        depth = 0
        for i, ch in enumerate(s):
            depth += ch == "{"
            depth -= ch == "}"
            if depth == 0 and ch == "}":
                break
        comps = _split_top_level(s[4:i])
        terms = parse_model_string("JC" + s[i + 1:])
        _refuse_seqerror(spec_str, terms, "a mixture")
        model = make_generic_mix(comps, aln)
        extras = {}
        rates = _build_rates(terms, extras, spec_str)
        return model, rates, extras

    spec = parse_model_string(spec_str)
    st = aln.seqtype.name
    extras: dict = {}

    # named protein mixtures (C10..C60, LG4M, LG4X, EX2, ...) and
    # base+profile combinations like LG+C20[+G...]
    base_up = spec.base.upper()
    kinds = {k for (k, _, _) in spec.rate_terms}
    mixture = base_up in MIXTURE_NAMES or bool(spec.other_terms)
    yaml_model = base_up in yamlmodels.MODELS
    codon = st.startswith("CODON") or base_up in CODON_NAMES
    if mixture or yaml_model or codon:
        what = ("a mixture" if mixture else "a YAML model" if yaml_model
                else "a codon model")
        _refuse_seqerror(spec_str, spec, what)
        _refuse_pomo(spec_str, spec, what)
    if mixture:
        if "H" in kinds:
            # the classes times the rate categories are the category axis,
            # which per-class lengths [E, H] do not match (the JAX package
            # fails inside its transition builder)
            raise SystemExit(f"-m {spec_str}: +H (per-class branch lengths) "
                             f"with a mixture model is not run by the JAX "
                             f"package")
        return _build_mixture_model(spec, aln, extras, spec_str)

    # user-defined YAML models (--mdef; phylo-yaml analog)
    if yaml_model:
        model = yamlmodels.make_yaml_model(base_up, aln)
        rates = _build_rates(spec, extras, spec_str)
        _refuse_nonrev_mixlen(spec_str, model, extras)
        return model, rates, extras

    # codon models
    if codon:
        model = make_codon_model(spec, aln)
        rates = _build_rates(spec, extras, spec_str)
        return model, rates, extras

    # ---------------- substitution model
    freqs = None
    freq_type = spec.freq_type
    if freq_type == "user" and spec.freq_params:
        freqs = np.asarray(spec.freq_params, dtype=np.float64)
        freqs = freqs / freqs.sum()
    elif freq_type == "empirical" and spec.freq_params:
        # "+F{...}" with explicit values behaves like user frequencies
        freqs = np.asarray(spec.freq_params, dtype=np.float64)
        freqs = freqs / freqs.sum()
        freq_type = "user"
    elif freq_type == "empirical":
        freqs = aln.state_frequencies()

    # nonreversible models, then the Lie-Markov names for DNA (a DNA model's
    # name wins), as in the JAX order; both return before the +E and +P
    # wrappers, so those terms are refused beside them
    lie_markov = (st == "DNA" and is_lie_markov_name(spec.base)
                  and not dna.is_dna_model_name(base_up))
    if base_up in ("UNREST", "NONREV") or lie_markov:
        what = "a nonreversible model" if not lie_markov else \
            "a Lie-Markov model"
        _refuse_seqerror(spec_str, spec, what)
        _refuse_pomo(spec_str, spec, what)
        if lie_markov:
            model = LieMarkovModel(spec.base, params=spec.base_params)
        else:
            model = UnrestModel(aln.num_states,
                                rates=(np.asarray(spec.base_params)
                                       if spec.base_params else None))
        rates = _build_rates(spec, extras, spec_str)
        _refuse_nonrev_mixlen(spec_str, model, extras)
        return model, rates, extras

    if st == "DNA" and dna.is_dna_model_name(base_up):
        # DNA named model; default '+F'-less behavior: counted frequencies
        # for F81/HKY-class models is 'empirical' per reference defaults
        canonical, code, def_freq = dna.DNA_MODELS.get(
            base_up, (spec.base, base_up, "estimate"))
        ft = freq_type or def_freq
        if ft == "empirical" and freqs is None:
            freqs = aln.state_frequencies()
        if ft == "estimate" and freqs is None:
            freqs = aln.state_frequencies()  # starting point for estimation
        model = dna.make_dna_model(base_up, freqs=freqs, freq_type=ft)
        if spec.base_params:
            model.set_rate_params(np.asarray(spec.base_params))
            model.fixed_rates = True
    elif st == "AA" and protein.is_protein_model_name(base_up):
        model = protein.make_protein_model(
            spec.base, freqs=freqs, freq_type=freq_type)
    elif base_up in ("MK", "JC2", "ORDERED") or st in ("BIN",) or \
            st.startswith("MORPH"):
        S = aln.num_states
        model = GTRModel(S, freq_type=freq_type or "equal",
                         freqs=freqs if freqs is not None
                         else np.full(S, 1.0 / S),
                         name=base_up, fixed_rates=True)
        if base_up == "ORDERED":
            # ordered states: only adjacent transitions
            iu = np.triu_indices(S, 1)
            model.exch_rates = np.where(
                iu[1] - iu[0] == 1, 1.0, 0.0).astype(np.float64)
    elif base_up == "GTR20":
        model = protein.make_protein_model("GTR20", freq_type=freq_type)
    else:
        raise ValueError(
            f"model {spec.base!r} not supported for seqtype {st}")

    if "P" in kinds:
        # the JAX package wraps the +E model and then replaces it by PoMo
        _refuse_seqerror(spec_str, spec, "a PoMo model")
    model = _maybe_wrap_seqerror(model, spec, extras, st)
    model = _maybe_pomo(model, spec, extras, st, aln)
    rates = _build_rates(spec, extras, spec_str)
    _refuse_nonrev_mixlen(spec_str, model, extras)
    return model, rates, extras


def _maybe_pomo(model, spec, extras: dict, st: str, aln):
    """+P{N}: replace the DNA model with the polymorphism-aware PoMo
    state space built on its mutation parameters (model/modelpomo.h:40)."""
    for kind, n, p in spec.rate_terms:
        if kind != "P":
            continue
        if st != "DNA":
            raise ValueError("PoMo (+P) requires DNA data")
        exch = getattr(model, "exch_rates", None)
        freqs = aln.state_frequencies()
        N = n or 9
        extras["pomo"] = N
        theta = p[0] if p else 0.01
        return PoMoModel(N=N, exch=exch, freqs=freqs, theta=theta,
                         fix_theta=bool(p))
    return model


def _maybe_wrap_seqerror(model, spec, extras: dict, st: str):
    """+E/+EA/+EC/+EG/+ET: wrap a DNA model with the sequencing-error tip
    transform (model/modeldnaerror.cpp)."""
    for kind, _, p in spec.rate_terms:
        if kind in _SEQERR_TERMS:
            if st != "DNA":
                raise ValueError("+E sequencing error requires DNA data")
            base = -1 if kind == "E" else "ACGT".index(kind[1])
            eps = p[0] if p else 0.05
            extras["seqerr"] = kind
            return DNAErrorModel(model, epsilon=eps, fix_epsilon=bool(p),
                                 error_base=base)
    return model


def _build_rates(spec: ModelSpec, extras: dict, spec_str: str) -> RateModel:
    """Rate-heterogeneity object from the +I/+G/+R/+ASC terms."""
    kinds = {k for (k, _, _) in spec.rate_terms}
    if "ASC" in kinds:
        extras["asc"] = True
    get = {k: (n, p) for (k, n, p) in spec.rate_terms}
    if "T" in kinds:
        # +T: tree-mixture model (IQTreeMix, tree/iqtreemix.h:21) — trees
        # supplied separately; weights optionally pinned by +T{w1,...}
        extras["treemix"] = True
        extras["treemix_weights"] = get["T"][1] or None
        kinds.discard("T")
    if "H" in kinds:
        # +H{k}: heterotachy (GHOST), k classes with their own branch
        # lengths; weights EM-optimized (tree/phylotreemixlen.cpp)
        if kinds - {"H"}:
            raise SystemExit(f"-m {spec_str}: +H cannot be combined with "
                             f"other rate terms")
        n, p = get["H"]
        extras["mixlen"] = n
        return RateHeterotachy(n, weights=p or None)

    # "+X{v}" brace parameters FIX the value (reference semantics: the model
    # string grammar of ModelFactory, model/modelfactory.cpp:151); the fix
    # flags live on the rate objects so every optimizer path honors them.
    p_inv = 0.0
    fix_pinv = False
    if "I" in kinds:
        n, p = get["I"]
        p_inv = p[0] if p else 0.1
        fix_pinv = bool(p)
        extras["fix_pinv"] = fix_pinv
    if "G" in kinds:
        n, p = get["G"]
        alpha = p[0] if p else 1.0
        fix_alpha = bool(p)
        extras["fix_alpha"] = fix_alpha
        if "I" in kinds:
            return RateGammaInvar(n, alpha=alpha, p_invar=p_inv,
                                  fix_alpha=fix_alpha, fix_pinv=fix_pinv)
        return RateGamma(n, alpha=alpha, fix_alpha=fix_alpha)
    if "R" in kinds:
        n, p = get["R"]
        rr = ww = None
        fix_fr = False
        if p:
            ww = np.asarray(p[0::2])
            rr = np.asarray(p[1::2])
            fix_fr = True
            extras["fix_free_rates"] = True
        if "I" in kinds:
            return RateFreeInvar(n, p_invar=p_inv, rates=rr, weights=ww,
                                 fix_rates=fix_fr, fix_pinv=fix_pinv)
        return RateFree(n, rates=rr, weights=ww, fix_rates=fix_fr)
    if "I" in kinds:
        return RateInvar(p_inv, fix_pinv=fix_pinv)
    return RateModel()


def _split_top_level(s: str) -> list[str]:
    """Split on commas not nested inside braces."""
    out, cur, depth = [], [], 0
    for ch in s:
        if ch == "{":
            depth += 1
        elif ch == "}":
            depth -= 1
        if ch == "," and depth == 0:
            out.append("".join(cur).strip())
            cur = []
        else:
            cur.append(ch)
    if cur:
        out.append("".join(cur).strip())
    return out


def _build_mixture_model(spec: ModelSpec, aln: Alignment, extras: dict,
                         spec_str: str):
    """Named mixture models: bare (C20, EX2, LG4X, ...) or base+profile
    (LG+C20, WAG+C60, ...). Reference analog: ModelMixture built-ins
    (model/modelmixture.cpp)."""
    base_up = spec.base.upper()
    if base_up in MIXTURE_NAMES:
        model = make_mixture(base_up, aln=aln)
    else:
        # base matrix + profile mixture, e.g. LG+C20
        prof = spec.other_terms[0]
        base_model = protein.make_protein_model(spec.base)
        model = make_mixture(prof, aln=aln,
                             base_exch=base_model.exch_rates)
        model.name = f"{base_model.name}+{prof}"
    rates = _build_rates(spec, extras, spec_str)
    # the published C10..C60/CF4 definitions are POISSON+G+FMIX{...}: bare
    # profile-mixture names imply discrete-gamma rates
    prof_name = (base_up if base_up in MIXTURE_NAMES
                 else spec.other_terms[0].upper())
    if not spec.rate_terms and prof_name.startswith(("C1", "C2", "C3",
                                                     "C4", "C5", "C6",
                                                     "CF")):
        rates = RateGamma(4, alpha=1.0)
    if model.fused_rates:
        # LG4M/*G4 or LG4X/*R4: force a matching 4-category rate model
        M = len(model.components)
        has_rate = len(rates.category_rates()) == M
        if not has_rate:
            rates = (RateFree(M) if model.name.upper().startswith("LG4X")
                     else RateGamma(M, alpha=1.0))
    return model, rates, extras
