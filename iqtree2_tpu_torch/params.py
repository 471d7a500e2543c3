"""Run configuration (the reference's Params struct, utils/tools.h:595,
reduced to the supported surface; defaults follow SURVEY A12).

Copied from iqtree2_tpu/params.py: the port keeps its own host
modules and imports nothing of the JAX package.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass
class Params:
    # input
    aln_file: str = ""
    seqtype: str | None = None        # -st
    partition_file: str = ""          # -p/-q/-spp
    partition_type: str = "edge-linked"  # -p: proportional, -q: equal, -Q
    user_tree: str = ""               # -te (fixed topology) / -t (start)
    start_tree: str = ""              # -t
    constraint_tree: str = ""         # -g
    out_prefix: str = ""              # -pre
    model: str = "MFP"                # -m
    # search
    seed: int = 1                     # -seed
    n_iterations: int | None = None   # -n
    min_iterations: int = 100
    max_iterations: int = 1000
    unsuccess_iteration: int = 100    # -nstop
    n_init_trees: int = 100           # -ninit
    n_nni_trees: int = 20             # -ntop
    pop_size: int = 5                 # -nbest
    pertub_strength: float = 0.5      # -pers
    loglh_epsilon: float = 0.001
    model_eps: float = 0.01           # -me
    fix_branch_lengths: bool = False  # -blfix
    # bootstrap / tests
    ufboot_replicates: int = 0        # -bb/-B
    standard_bootstrap: int = 0       # -b
    alrt_replicates: int = 0          # -alrt
    abayes: bool = False              # -abayes
    lbp_replicates: int = 0           # -lbp
    num_runs: int = 1                 # --runs
    tbe: bool = False                 # --tbe (transfer bootstrap)
    bnni: bool = False                # -bnni (refine UFBoot trees)
    write_ml_rate: bool = False       # --mlrate (per-site ML rates)
    symtest: bool = False             # --symtest
    symtest_remove_bad: bool = False  # --symtest-remove-bad
    symtest_pval: float = 0.05        # --symtest-pval
    root_test: bool = False           # --root-test (root position test)
    merge_algorithm: str = "greedy"   # --merge greedy|kmeans
    mset: str = ""                    # -mset (restrict base models)
    mrate: str = ""                   # -mrate (restrict rate schemes)
    cmax: int = 10                    # -cmax (max +Rk categories)
    merit: str = "BIC"                # -merit AIC|AICc|BIC (model_test_criterion)
    # distributed search (reference: MPI run mode, main/main.cpp:2200)
    dist_nranks: int = 1              # --dist-nranks (launch N processes)
    dist_rank: int = 0                # --dist-rank (this process's rank)
    dist_dir: str = ""                # --dist-dir (FileGossip directory)
    boot_spec: str = ""               # -bsam SITE|GENE|GENESITE
    sim_nprocs: int = 1               # --alisim-nprocs (MPI-style split)
    sim_rank: int = 0                 # --alisim-rank
    # numerics
    min_branch_length: float = 1e-6   # -blmin
    max_branch_length: float = 10.0   # -blmax
    use_f64: bool = False             # --f64 (parity mode)
    # topology tests / outputs
    user_trees_file: str = ""         # -z (tree-set evaluation)
    topo_test_replicates: int = 10000  # -zb
    do_au_test: bool = False          # -au
    do_asr: bool = False              # -asr (ancestral state reconstruction)
    write_site_rate: bool = False     # -wsr (.rate)
    write_site_prob: str = ""         # -wspr/-wspm/-wspmr (.siteprob)
    write_ml_dist: bool = False       # -mldist (.mldist matrix)
    lmap_quartets: int = 0            # -lmap (likelihood mapping)
    gcf_tree_file: str = ""           # --gcf (gene trees for gCF)
    scf_quartets: int = 0             # --scf (site concordance factor)
    rf_tree_file: str = ""            # -rf / -rf_all
    rf_all: bool = False
    consensus_of: str = ""            # -con FILE (consensus of a tree set)
    random_tree_n: int = 0            # -r N (generate a random tree)
    random_tree_model: str = "yule"   # yule|uniform|caterpillar|balanced|star
    # control
    redo: bool = False
    no_checkpoint: bool = False
    verbose: int = 1
    write_site_lh: bool = False       # -wsl
    pmsf: bool = False                # --pmsf (two-pass site frequencies)
    date_file: str = ""               # --date (tip dates for LSD dating)
    date_ci: int = 0                  # --date-ci (CI replicates, LSD -f)
    clock_sd: float = 0.2             # --clock-sd (relaxed sd, LSD -q)
    date_root: str = ""               # --date-root (root date, LSD -a)
    date_rate: str = ""               # --date-rate (given rate, LSD -w)
    date_no_outgroup: bool = False    # --date-no-outgroup (LSD -G)
    outgroup: str = ""                # -o (outgroup taxa, comma-sep)
    mdef_file: str = ""               # --mdef (YAML model definitions)
    # simulation (AliSim)
    alisim: str = ""                  # --alisim output prefix
    sim_length: int = 1000
    sim_num_alignments: int = 1
    indel: str = ""                   # --indel ins,del rates
    indel_size: float = 3.0           # --indel-size mean (GEO)

    @property
    def prefix(self) -> str:
        return self.out_prefix or self.aln_file or "iqtree2_tpu_torch"
