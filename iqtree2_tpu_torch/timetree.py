"""Time trees: least-squares molecular dating (LSD2 analog).

Reference analog: doTimeTree (main/timetree.cpp:335) -> lsd::buildTimeTree
(:297) — the LSD2 submodule implements To et al. (2016) "Fast dating using
least-squares criteria and algorithms". This module implements the same
WLS criterion:

  minimize  sum_e w_e * (b_e - omega * (t_child - t_parent))^2

over internal-node dates t and the clock rate omega, subject to temporal
ordering t_parent <= t_child - eps. With z := omega * t the objective is
LINEAR least squares in (z_internal, omega) given tip dates; ordering
constraints are enforced by an active-set loop that collapses violated
edges (t_parent = t_child) and re-solves — the same projection LSD uses.

Input: tip dates from a file of "name date" lines (reference --date
format); outgroup or midpoint rooting of the unrooted ML tree.

Copied from iqtree2_tpu/timetree.py, with date_tree_ci counting the
replicates whose dating failed and returning that count, which
write_lsd_report prints (the JAX function drops them silently, ROADMAP
C5): the port keeps its own host modules and imports nothing of the JAX
package.
"""

from __future__ import annotations

import numpy as np

from iqtree2_tpu_torch.tree.topology import Tree


def parse_date_file(text: str, names: list[str]) -> dict[int, float]:
    """'name date' per line (the reference's --date TAXFILE format; a
    leading count line is tolerated)."""
    name_to_id = {n: i for i, n in enumerate(names)}
    out: dict[int, float] = {}
    for ln in text.splitlines():
        ln = ln.strip()
        if not ln or ln.startswith("#"):
            continue
        parts = ln.split()
        if len(parts) == 1 and parts[0].isdigit():
            continue
        if parts[0] in name_to_id:
            out[name_to_id[parts[0]]] = float(parts[1])
    if not out:
        raise ValueError("no tip dates parsed from date file")
    return out


def dates_from_names(names: list[str]) -> dict[int, float]:
    """--date TAXNAME mode: the date is the suffix after the last '|' in
    each taxon name (reference readDateTaxName, main/timetree.cpp:105)."""
    out: dict[int, float] = {}
    for i, name in enumerate(names):
        pos = name.rfind("|")
        if pos < 0:
            continue
        try:
            out[i] = float(name[pos + 1:])
        except ValueError:
            continue
    if not out:
        raise ValueError("no tip dates parsed from taxon names "
                         "(expected 'name|date')")
    return out


def outgroup_root_edge(tree: Tree, outgroup: list[str],
                       names: list[str]) -> tuple[int, int]:
    """Edge whose removal separates the outgroup taxa from the rest
    (reference: -o outgroup rooting, writeOutgroup main/timetree.cpp:126).

    For a multi-taxon outgroup the edge subtending their MRCA-side
    subtree is found by scanning splits; raises if the outgroup is not
    monophyletic in the unrooted tree."""
    name_to_id = {n: i for i, n in enumerate(names)}
    og = set()
    for n in outgroup:
        if n not in name_to_id:
            raise ValueError(f"outgroup taxon '{n}' not in alignment")
        og.add(name_to_id[n])
    L = tree.ntaxa
    if len(og) == 1:
        tip = next(iter(og))
        nb = next(iter(tree.adj[tip]))
        return tip, nb
    # for every edge, the taxon set on each side; pick the edge whose
    # one side == outgroup set
    for a in list(tree.adj):
        for b in tree.adj[a]:
            if a >= b:
                continue
            # collect leaves on b-side of edge (a, b)
            seen = {a, b}
            stack = [b]
            side = set()
            while stack:
                v = stack.pop()
                if v < L:
                    side.add(v)
                for u in tree.adj[v]:
                    if u not in seen:
                        seen.add(u)
                        stack.append(u)
            if side == og or side == (set(range(L)) - og):
                return a, b
    raise ValueError("outgroup is not monophyletic on the ML tree")


def midpoint_root(tree: Tree) -> tuple[int, int, float]:
    """(a, b, frac) of the midpoint edge: root at frac along edge (a, b)."""
    L = tree.ntaxa
    # farthest pair by path length
    def far(from_v):
        seen = {from_v: 0.0}
        stack = [from_v]
        best = (from_v, 0.0)
        while stack:
            v = stack.pop()
            for u in tree.adj[v]:
                if u not in seen:
                    seen[u] = seen[v] + tree.get_blen(v, u)
                    stack.append(u)
                    if u < L and seen[u] > best[1]:
                        best = (u, seen[u])
        return best, seen

    (x, _), _ = far(0)
    (y, dxy), dist_x = far(x)
    # walk back from y toward x accumulating half the distance
    target = dxy / 2.0
    # path y -> x
    parent = {x: None}
    stack = [x]
    while stack:
        v = stack.pop()
        for u in tree.adj[v]:
            if u not in parent:
                parent[u] = v
                stack.append(u)
    path = [y]
    while path[-1] != x:
        path.append(parent[path[-1]])
    acc = 0.0
    for i in range(len(path) - 1):
        a, b = path[i], path[i + 1]
        ln = tree.get_blen(a, b)
        if acc + ln >= target:
            return a, b, (target - acc) / max(ln, 1e-12)
        acc += ln
    return path[-2], path[-1], 0.5


def date_tree(tree: Tree, tip_dates: dict[int, float],
              root_edge: tuple[int, int] | None = None,
              min_rate: float = 1e-10, eps: float = 1e-9,
              max_iter: int = 30, fixed_rate: float | None = None,
              root_date: float | None = None):
    """WLS dating. Returns (node_dates dict, rate, rooted_parent map).

    Tips without a date are dated too (relaxed tips). When all tip dates
    are equal an ultrametric tree is produced and the rate is
    unidentifiable (set so root age = 1). fixed_rate pins the clock rate
    (LSD -w given-rate mode); root_date pins the root's date (LSD -a)."""
    t = tree.copy()
    L = t.ntaxa
    if root_edge is None:
        a, b, frac = midpoint_root(t)
    else:
        a, b = root_edge
        frac = 0.5
    # insert root node on edge (a, b)
    root = t.new_node()
    ln = t.get_blen(a, b)
    t.remove_edge(a, b)
    t.add_edge(a, root, ln * frac)
    t.add_edge(root, b, ln * (1 - frac))

    # rooted orientation
    parent: dict[int, int | None] = {root: None}
    order = [root]
    stack = [root]
    while stack:
        v = stack.pop()
        for u in t.adj[v]:
            if u not in parent:
                parent[u] = v
                order.append(u)
                stack.append(u)

    nodes = order
    free = [v for v in nodes if v not in tip_dates]   # undated nodes
    col = {v: k for k, v in enumerate(free)}
    n_free = len(free)

    # one LS row per edge: b_e = z_child - z_parent, z_v = omega * t_v for
    # dated tips (omega is the last column)
    rows, rhs = [], []
    for v in nodes:
        p = parent[v]
        if p is None:
            continue
        row = np.zeros(n_free + 1)
        if v in tip_dates:
            row[-1] += tip_dates[v]
        else:
            row[col[v]] += 1.0
        if p in tip_dates:
            row[-1] -= tip_dates[p]
        else:
            row[col[p]] -= 1.0
        rows.append(row)
        rhs.append(t.get_blen(v, p))
    A = np.stack(rows)
    y = np.asarray(rhs)

    dates_all_equal = (len(set(tip_dates.values())) <= 1
                       and fixed_rate is None and root_date is None)
    if dates_all_equal:
        # the rate is unidentifiable: fix omega = 1 conceptually and pin
        # the root one time unit before the (common) tip date
        d0 = next(iter(tip_dates.values()))
        prior = np.zeros(n_free + 1)
        prior[col[root]] = 1e3
        A = np.vstack([A, prior])
        y = np.concatenate([y, [1e3 * (d0 - 1.0)]])
    if fixed_rate is not None:
        # LSD given-rate mode (-w): heavy prior pinning omega
        prior = np.zeros(n_free + 1)
        prior[-1] = 1e6
        A = np.vstack([A, prior])
        y = np.concatenate([y, [1e6 * fixed_rate]])
    if root_date is not None:
        # LSD -a: pin the root date; z_root - omega*root_date = 0
        prior = np.zeros(n_free + 1)
        prior[col[root]] = 1e6
        prior[-1] = -1e6 * root_date
        A = np.vstack([A, prior])
        y = np.concatenate([y, [0.0]])

    x, *_ = np.linalg.lstsq(A, y, rcond=None)
    omega = max(x[-1], min_rate) if not dates_all_equal else 1.0

    def z_of(v):
        return x[col[v]] if v in col else omega * tip_dates[v]

    # active-set projection: children may not predate parents
    for _ in range(max_iter):
        viol = [(v, parent[v]) for v in nodes
                if parent[v] is not None and
                z_of(v) < z_of(parent[v]) - 1e-12]
        if not viol:
            break
        # collapse each violated edge: force z_child = z_parent by adding
        # a heavy tie row, then re-solve
        extra = []
        for v, p in viol:
            row = np.zeros(n_free + 1)
            if v in col:
                row[col[v]] += 1e4
            else:
                continue
            if p in col:
                row[col[p]] -= 1e4
            A = np.vstack([A, row])
            y = np.concatenate([y, [0.0]])
        x, *_ = np.linalg.lstsq(A, y, rcond=None)
        omega = max(x[-1], min_rate) if not dates_all_equal else 1.0

    dates = {v: z_of(v) / omega for v in nodes}
    # final sanity clamp
    for v in order:
        p = parent[v]
        if p is not None and dates[v] < dates[p]:
            dates[v] = dates[p]
    return dates, float(omega), parent, t, root


def timetree_newick(t: Tree, dates: dict[int, float],
                    parent: dict, root: int) -> str:
    """Newick with branch lengths in TIME units (child - parent dates)."""
    for v, p in parent.items():
        if p is not None:
            t.set_blen(v, p, max(dates[v] - dates[p], 0.0))
    return t.to_newick(root=root)


def date_tree_ci(tree: Tree, tip_dates: dict[int, float],
                 seq_len: int, n_reps: int = 100,
                 clock_sd: float = 0.2,
                 root_edge: tuple[int, int] | None = None,
                 fixed_rate: float | None = None,
                 root_date: float | None = None,
                 seed: int = 1, c_param: float = 10.0):
    """Confidence intervals by branch-length resampling (LSD2 -f mode,
    To et al. 2016 §2.5; reference main/timetree.cpp:216 date_replicates).

    Each replicate perturbs every branch length with the SAME variance
    model the WLS criterion assumes, sigma_e^2 = (b_e + c/s)/s, plus an
    optional lognormal relaxed-clock multiplier of stddev ``clock_sd``
    (LSD -q), then re-dates. Returns (dates_ci {node: (lo, hi)},
    rate_ci (lo, hi), n_failed) at the 2.5/97.5 percentiles of the
    replicates whose dating succeeded; n_failed counts the others."""
    rng = np.random.default_rng(seed)
    base = tree.copy()
    edges = [(a, b) for a in list(base.adj) for b in base.adj[a] if a < b]
    b0 = np.array([base.get_blen(a, b) for a, b in edges])
    sig = np.sqrt(np.maximum(b0 + c_param / seq_len, 0.0) / seq_len)
    all_dates: list[dict[int, float]] = []
    rates = []
    n_failed = 0
    for _ in range(n_reps):
        bs = b0 + rng.normal(0.0, sig)
        if clock_sd > 0:
            bs = bs * np.exp(rng.normal(0.0, clock_sd, size=bs.shape))
        bs = np.maximum(bs, 1e-9)
        rt = base.copy()
        for (a, b), v in zip(edges, bs):
            rt.set_blen(a, b, float(v))
        try:
            nd, rate, _, _, root = date_tree(
                rt, tip_dates, root_edge=root_edge,
                fixed_rate=fixed_rate, root_date=root_date)
        except Exception:
            n_failed += 1
            continue
        all_dates.append(nd)
        rates.append(rate)
    if not all_dates:
        return {}, (float("nan"), float("nan")), n_failed
    keys = set(all_dates[0])
    for d in all_dates[1:]:
        keys &= set(d)
    ci = {}
    for k in keys:
        vals = np.array([d[k] for d in all_dates])
        ci[k] = (float(np.percentile(vals, 2.5)),
                 float(np.percentile(vals, 97.5)))
    r = np.array(rates)
    return ci, (float(np.percentile(r, 2.5)),
                float(np.percentile(r, 97.5))), n_failed


def timetree_nexus(t: Tree, dates: dict[int, float], parent: dict,
                   root: int, names: list[str],
                   ci: dict[int, tuple[float, float]] | None = None
                   ) -> str:
    """NEXUS time tree with per-node date (and optional CI) annotations,
    the LSD2 .nex output surface (reference main/timetree.cpp:301)."""
    for v, p in parent.items():
        if p is not None:
            t.set_blen(v, p, max(dates[v] - dates[p], 0.0))

    def label(v):
        base = names[v] if v < t.ntaxa else ""
        com = f"[&date={dates[v]:.6g}"
        if ci and v in ci:
            com += f",CI_date={{{ci[v][0]:.6g},{ci[v][1]:.6g}}}"
        return base + com + "]"

    def rec(v, p):
        kids = [u for u in t.adj[v] if u != p]
        if not kids:
            return label(v)
        inner = ",".join(rec(u, v) + f":{t.get_blen(u, v):.10g}"
                         for u in kids)
        return "(" + inner + ")" + label(v)

    return ("#NEXUS\nbegin trees;\n  tree 1 = " + rec(root, None)
            + ";\nend;\n")


def write_lsd_report(path: str, dates: dict[int, float], rate: float,
                     root: int, tree: Tree, names: list[str],
                     rate_ci=None, date_ci=None, n_reps: int = 0,
                     n_failed: int = 0):
    """.timetree.lsd-style summary report (reference writes LSD's
    outResult stream to <prefix>.timetree.lsd, main/timetree.cpp:299);
    with replicates, how many of them failed."""
    with open(path, "w") as f:
        f.write("Least-squares dating (WLS, LSD2 analog)\n")
        f.write(f"rate {rate:.8g}")
        if rate_ci:
            f.write(f", CI:[{rate_ci[0]:.8g}; {rate_ci[1]:.8g}]")
        f.write(f"\ntMRCA {dates[root]:.8g}")
        if date_ci and root in date_ci:
            f.write(f", CI:[{date_ci[root][0]:.8g}; "
                    f"{date_ci[root][1]:.8g}]")
        f.write("\n")
        if n_reps:
            f.write(f"confidence intervals: {n_reps} branch-resampling "
                    f"replicates\n")
            f.write(f"failed replicates: {n_failed} of {n_reps}\n")
        f.write("\nNode dates:\n")
        for v in sorted(dates):
            nm = names[v] if v < tree.ntaxa else f"node{v}"
            f.write(f"  {nm}\t{dates[v]:.8g}")
            if date_ci and v in date_ci:
                f.write(f"\tCI:[{date_ci[v][0]:.6g}; "
                        f"{date_ci[v][1]:.6g}]")
            f.write("\n")
