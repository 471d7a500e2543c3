"""ModelFinder: best-fit model selection over a (model x rate) grid.

Copied from iqtree2_tpu/modelfinder.py (run_modelfinder and what it
calls), on the port's engine: the port keeps its own host modules and
imports nothing of the JAX package. The candidate order, the warm starts
carried from fit to fit in that order, the branch lengths of the first fit
reused by every later one, the two-stage screen, the lazy +Rk expansion and
the final refit are the JAX package's, so both packages fit the same models
from the same starting points. Two additions: the result carries the wall
seconds of each stage, and the checkpoint also keeps the screened fits
(under ``screen.``), so a resumed run over a finished ModelFinder struct
fits nothing.

Every candidate fit goes through model/optimize.optimize_model_parameters:
the joint fit (model/torchfit.py, differentiated plain torch, no pruning
kernel) where it applies, else the host alternation, whose log-likelihoods
and Newton rounds run the pruning kernels on a card.

Reference analog: runModelFinder (main/phylotesting.cpp:775): candidate
grid from per-datatype model lists x rate schemes, each fitted on a fixed
ModelFinder topology (parsimony start tree), scored by AIC/AICc/BIC;
previous fits reused via checkpoint. TEST = {,+I,+G,+I+G}; MFP adds
+R2..+Rk.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from iqtree2_tpu_torch.data.alignment import Alignment
from iqtree2_tpu_torch.engine import LikelihoodEngine
from iqtree2_tpu_torch.model.factory import build_model
from iqtree2_tpu_torch.model.optimize import optimize_model_parameters
from iqtree2_tpu_torch.model.rates import RateGamma
from iqtree2_tpu_torch.model.subst import GTRModel
from iqtree2_tpu_torch.ops.pars import random_stepwise_addition

# reference DNA candidate list (main/phylotesting.cpp:60-124, named subset)
DNA_MODEL_NAMES = ["JC", "F81", "K2P", "HKY", "TNe", "TN", "K3P", "K3Pu",
                   "TPM2", "TPM2u", "TPM3", "TPM3u", "TIMe", "TIM",
                   "TIM2e", "TIM2", "TIM3e", "TIM3", "TVMe", "TVM",
                   "SYM", "GTR"]
# protein list (main/phylotesting.cpp:126)
AA_MODEL_NAMES = ["Dayhoff", "mtREV", "JTT", "WAG", "cpREV", "mtMAM",
                  "LG", "mtART", "mtZOA", "VT", "rtREV", "DCMut", "PMB",
                  "HIVb", "HIVw", "JTTDCMut", "FLU", "Blosum62",
                  "mtMet", "mtVer", "mtInv", "Q.pfam", "Q.bird",
                  "Q.mammal", "Q.insect", "Q.plant", "Q.yeast"]
MODES = ("MFP", "TEST", "MF", "TESTONLY", "AUTO")
TOP_K = 8            # screened candidates refit to the normal schedule
SCREEN_ITERS = 8     # L-BFGS iterations of a screening fit
FIT_ROUNDS = 3       # alternation rounds of a candidate fit
FIT_BLEN_ROUNDS = 4  # Newton sweeps of its branch-length steps
FIT_EPS = 0.1        # least epsilon of a candidate fit


def rate_schemes(mode: str, max_rk: int = 10) -> list[str]:
    base = ["", "+I", "+G", "+I+G"]
    if mode.upper() in ("MFP", "MF"):
        base = base + [f"+R{k}" for k in range(2, max_rk + 1)]
    return base


def candidate_models(aln: Alignment, mode: str = "MFP") -> list[str]:
    """Flat candidate list (kept for introspection / tests)."""
    out = []
    for b in candidate_bases(aln):
        for r in rate_schemes(mode):
            out.append(b + r)
    return out


def candidate_bases(aln: Alignment) -> list[str]:
    st = aln.seqtype.name
    if st == "DNA":
        bases = list(DNA_MODEL_NAMES)
    elif st == "AA":
        bases = []
        for b in AA_MODEL_NAMES:
            bases.append(b)
            bases.append(b + "+F")
    elif st == "BIN":
        bases = ["JC2"]
    else:
        bases = ["MK"]
    return bases


def information_scores(logL: float, df: int, n_sites: int) -> dict:
    aic = -2 * logL + 2 * df
    if n_sites - df - 1 > 0:
        aicc = aic + 2.0 * df * (df + 1) / (n_sites - df - 1)
    else:
        aicc = np.inf
    bic = -2 * logL + df * np.log(n_sites)
    return {"AIC": aic, "AICc": aicc, "BIC": bic}


def _restrict(aln: Alignment, params, bases: list[str]):
    """-mset restricts the base models, -mrate the rate schemes (reference:
    params.model_set / ratehet_set, main/phylotesting.cpp). Returns (bases,
    base rate schemes, whether +R may be tried: None = as the mode says)."""
    base_rates = ["", "+I", "+G", "+I+G"]
    lazy_rk = None
    mset = getattr(params, "mset", "")
    if mset:
        want = {m.strip().upper() for m in mset.split(",") if m.strip()}
        bases = [b for b in bases
                 if b.upper() in want or
                 b.upper().replace("+F", "") in want]
        if not bases:
            raise ValueError(f"-mset {mset}: no matching models for "
                             f"{aln.seqtype.name}")
    mrate = getattr(params, "mrate", "")
    if mrate:
        rmap = {"E": "", "": "", "I": "+I", "G": "+G", "I+G": "+I+G",
                "G+I": "+I+G", "R": "+R"}
        want_r = [rmap.get(r.strip().upper(), None)
                  for r in mrate.split(",") if r.strip()]
        if None in want_r:
            raise ValueError(f"-mrate {mrate}: unknown scheme")
        base_rates = [r for r in ["", "+I", "+G", "+I+G"] if r in want_r]
        # -mrate R enables the +Rk expansion in any mode
        lazy_rk = "+R" in want_r
    return bases, base_rates, lazy_rk


def run_modelfinder(aln: Alignment, params, log=print, ckp=None,
                    criterion: str | None = None, tree=None,
                    mode: str | None = None, device="cuda") -> dict:
    """Evaluate the candidate grid on a fixed topology; return best model.

    Returns {"best": name, "criterion": ..., "table": [entries sorted by
    the criterion], "seconds": {stage: wall seconds}}; an entry holds name,
    logL, df, AIC, AICc and BIC. Lazy +Rk expansion: stop increasing k when
    the criterion worsens (reference: :1307-1330). The fits run on
    ``device`` in float32.
    """
    if criterion is None:
        criterion = getattr(params, "merit", "") or "BIC"
    mode = mode or params.model
    rng = np.random.default_rng(params.seed)
    if tree is None:
        tree = random_stepwise_addition(aln, rng)
    bases, base_rates, lazy_rk = _restrict(aln, params,
                                           candidate_bases(aln))
    if lazy_rk is None:
        lazy_rk = mode.upper() in ("MFP", "MF")
    max_rk = int(getattr(params, "cmax", 10) or 10)
    log(f"ModelFinder: testing {len(bases)} base models x rate schemes "
        f"({'+R2..+R%d lazily' % max_rk if lazy_rk else 'TEST set'}) "
        f"on a fixed parsimony topology...")

    if ckp is not None:
        ckp.start_struct("ModelFinder")
    results = []
    seconds = {"screen": 0.0, "refit": 0.0, "+R": 0.0, "final refit": 0.0}
    # branch lengths from the FIRST fit are reused for every later model
    # (order-independent, unlike a rolling cache; reference keeps the
    # ModelFinder tree fixed across candidates)
    blen_cache: dict | None = None
    # warm starts: candidate fits share one topology and similar optima,
    # so each model's exchangeabilities / alpha / p_inv start from the
    # previous fit's (reference analog: ModelFinder reuses previous
    # estimates, main/phylotesting.cpp:775 init_* plumbing)
    warm: dict = {"exch": None, "alpha": None, "pinv": None}
    # one engine per +ASC value serves the whole grid: the alignment and
    # tip set-up do not depend on the model, refresh_model rebuilds the
    # model pack
    shared_eng: dict = {}

    def evaluate(name: str, quick: bool = False) -> dict | None:
        nonlocal blen_cache
        key = f"screen.{name}" if quick else name
        if ckp is not None:
            for k in (name, key):     # a full fit stands in for a screen
                if ckp.has(k):
                    return dict(ckp.get(k))
        try:
            model, rates, extras = build_model(name, aln)
        except ValueError:
            return None
        if (warm["exch"] is not None and type(model) is GTRModel
                and not model.fixed_rates
                and len(model.exch_rates) == len(warm["exch"])):
            model.exch_rates = warm["exch"].copy()
            # re-tie equality classes to their representative values
            model.set_rate_params(model.get_rate_params())
        if warm["alpha"] and isinstance(rates, RateGamma) \
                and not rates.fix_alpha:
            rates.alpha = warm["alpha"]
        if warm["pinv"] and hasattr(rates, "_p_invar") \
                and not getattr(rates, "fix_pinv", False) \
                and rates.p_invar > 0:
            rates._p_invar = min(warm["pinv"], 0.8)
        asc = extras.get("asc", False)
        eng = shared_eng.get(asc)
        if eng is None:
            eng = LikelihoodEngine(aln, model, rates, dtype=torch.float32,
                                   device=device, asc=asc)
            shared_eng[asc] = eng
        else:
            eng.model = model
            eng.rates = rates
            eng.refresh_model()
        t = tree.copy()
        if blen_cache is not None:
            for k, v in blen_cache.items():
                if k in t.blen:
                    t.blen[k] = v
        logL = optimize_model_parameters(
            eng, t, epsilon=max(params.model_eps, FIT_EPS),
            max_rounds=FIT_ROUNDS, blen_rounds=FIT_BLEN_ROUNDS,
            screen_iters=SCREEN_ITERS if quick else None)
        if blen_cache is None:
            blen_cache = dict(t.blen)
        if type(model) is GTRModel and not model.fixed_rates:
            warm["exch"] = np.asarray(model.exch_rates, float).copy()
        if isinstance(rates, RateGamma) and not rates.fix_alpha:
            warm["alpha"] = float(rates.alpha)
        if getattr(rates, "p_invar", 0.0) > 0:
            warm["pinv"] = float(rates.p_invar)
        df = (model.num_free_params() + rates.num_free_params()
              + t.num_edges())
        entry = {"name": name, "logL": float(logL), "df": int(df)}
        entry.update(information_scores(logL, df, aln.nsites))
        if quick:
            entry["_screened"] = True
        if ckp is not None:
            ckp.put(key, entry)
            ckp.dump()
        return dict(entry)

    def logged(e: dict, note: str = "") -> dict:
        log(f"  {e['name']:<18} logL {e['logL']:.3f}  BIC {e['BIC']:.3f}"
            f"{note}")
        return e

    def finish(results: list) -> dict:
        for e in results:
            e.pop("_screened", None)
        if ckp is not None:
            ckp.dump(force=True)
            ckp.end_struct()
        results.sort(key=lambda e: e[criterion])
        log("ModelFinder wall seconds: " + ", ".join(
            f"{k} {v:.3f}" for k, v in seconds.items()))
        return {"best": results[0]["name"], "criterion": criterion,
                "table": results, "seconds": seconds}

    if mode.upper() == "AUTO":
        # -m AUTO ordering (reference: main/phylotesting.cpp:1347-1360):
        # all rate schemes on the FIRST base model pick the best scheme;
        # every other base is then tried only with that scheme (plus the
        # bare model), avoiding the full grid.
        t0 = time.perf_counter()
        first = bases[0]
        rate_entries = []
        for r in base_rates + [f"+R{k}" for k in range(2, 6)]:
            e = evaluate(first + r)
            if e is not None:
                rate_entries.append((r, e))
                results.append(logged(e))
        best_rate = min(rate_entries, key=lambda re_: re_[1][criterion])[0]
        log(f"AUTO: best rate scheme on {first}: "
            f"{best_rate or '(none)'}")
        for base in bases[1:]:
            for r in dict.fromkeys(["", best_rate]):
                e = evaluate(base + r)
                if e is None:
                    break
                results.append(logged(e))
        seconds["refit"] = time.perf_counter() - t0
        return finish(results)

    # TWO-STAGE screen: a quick 8-iteration warm-started pass ranks the
    # whole grid, then the top candidates are refit to the normal schedule
    # so the reported winner and its scores are converged. Reference
    # analog: ModelFinder's own staged epsilons (main/phylotesting.cpp:2836
    # runs a cruder tree for screening).
    t0 = time.perf_counter()
    stage1: list[dict] = []
    for base in bases:
        for r in base_rates:
            entry = evaluate(base + r, quick=True)
            if entry is None:
                break
            stage1.append(logged(entry, "  (screen)"))
    stage1.sort(key=lambda e: e[criterion])
    seconds["screen"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    refit = {e["name"] for e in stage1[:TOP_K]}
    log(f"Refitting top {len(refit)} of {len(stage1)} screened models "
        f"({criterion})...")
    for e in stage1:
        if e["name"] in refit:
            full = evaluate(e["name"])
            if full is not None:
                e = logged(full)
        results.append(e)
    seconds["refit"] = time.perf_counter() - t0
    if lazy_rk:
        # lazy +Rk expansion per base, k by k: a base leaves when its
        # criterion worsens (reference rule: MF_WAITING lazy flags,
        # main/phylotesting.cpp:1307)
        t0 = time.perf_counter()
        active = {b: None for b in bases}
        for k in range(2, max_rk + 1):
            live = [b for b in active]
            if not live:
                break
            for b in live:
                entry = evaluate(f"{b}+R{k}", quick=True)
                if entry is None:
                    del active[b]
                    continue
                results.append(logged(entry))
                prev = active[b]
                if prev is not None and entry[criterion] > prev:
                    del active[b]
                else:
                    active[b] = entry[criterion]
        seconds["+R"] = time.perf_counter() - t0
    # final refit: any screened entry that made the overall top set gets
    # the full fit schedule, so the winner and its scores are converged
    t0 = time.perf_counter()
    results.sort(key=lambda e: e[criterion])
    for i, e in enumerate(list(results[:TOP_K])):
        if e.get("_screened"):
            full = evaluate(e["name"])
            if full is not None:
                results[i] = full
    seconds["final refit"] = time.perf_counter() - t0
    return finish(results)
