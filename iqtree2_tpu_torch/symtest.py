"""Pair divergence counts of the matched-pairs symmetry tests.

Copied from iqtree2_tpu/symtest.py, divergence_matrix alone (what the
WH test of whtest.py runs): the port keeps its own host modules and imports
nothing of the JAX package. Reference analog: the divergence matrix n_ij of
doSymTest (main/phyloanalysis.cpp:3920).
"""

from __future__ import annotations

import numpy as np

from iqtree2_tpu_torch.data.alignment import Alignment


def divergence_matrix(aln: Alignment, i: int, j: int) -> np.ndarray:
    """[S, S] counts of (state_i, state_j) over definite-state sites."""
    S = aln.num_states
    codes = aln.tip_codes()
    tbl = aln.seqtype.tip_table
    definite = tbl.sum(1) == 1.0
    state_of = tbl.argmax(1)
    ci, cj = codes[i], codes[j]
    ok = definite[ci] & definite[cj]
    w = aln.pattern_weights
    N = np.zeros((S, S))
    np.add.at(N, (state_of[ci[ok]], state_of[cj[ok]]), w[ok])
    return N
