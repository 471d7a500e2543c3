"""Command line of the PyTorch/CUDA port (counterpart of iqtree2_tpu/cli.py).

  python -m iqtree2_tpu_torch -s ALN -m MODEL [-te TREE [-blfix]]
                              [-bb N] [-n N] [-nstop N] [-ninit N]
                              [-ntop N] [-nbest N] [-pers X] [--f64]
                              [--device cuda|cpu]

The flags are the JAX package's (its build_parser and params_from_args are
reused) plus ``--device``, the counterpart of IQTREE2_TPU_PLATFORM: ``cuda``
(the default) runs the Hopper kernels and fails where there is no card;
``cpu`` runs their plain PyTorch versions. The port runs the fixed-topology
model fit (-te) and the stochastic tree search with ultrafast bootstrap;
any flag whose path is not yet ported stops the run with a SystemExit that
names it, so nothing is silently ignored.
"""

from __future__ import annotations

import argparse
import sys

from iqtree2_tpu import cli as tpu_cli

# argparse destinations the port honours; num_threads is accepted for
# compatibility only, as in the JAX package
PORTED_DESTS = frozenset({
    "aln_file", "seqtype", "user_tree", "out_prefix", "model", "seed",
    "model_eps", "fix_branch_lengths", "use_f64", "redo", "quiet",
    "num_threads", "device", "n_iterations", "unsuccess_iteration",
    "n_init_trees", "n_nni_trees", "pop_size", "pertub_strength",
    "ufboot_replicates"})
MODEL_SELECTION = ("MFP", "TEST", "MF", "TESTONLY", "AUTO", "WHTEST")


def build_parser() -> argparse.ArgumentParser:
    p = tpu_cli.build_parser()
    p.prog = "iqtree2_tpu_torch"
    p.description = ("PyTorch/CUDA port of iqtree2_tpu: maximum-likelihood "
                     "model fit and tree search with ultrafast bootstrap")
    p.add_argument("--device", dest="device", choices=("cuda", "cpu"),
                   default="cuda",
                   help="cuda (default): the Hopper kernels, an error where "
                        "no card is present; cpu: their plain PyTorch "
                        "versions")
    return p


def refuse_unported(args: argparse.Namespace,
                    parser: argparse.ArgumentParser) -> None:
    """SystemExit naming the first given flag whose path is not ported."""
    for action in parser._actions:
        if not action.option_strings or action.dest in PORTED_DESTS:
            continue
        default = parser.get_default(action.dest)
        if getattr(args, action.dest, default) != default:
            raise SystemExit(f"{'/'.join(action.option_strings)}: not yet "
                             f"ported to iqtree2_tpu_torch")
    if args.user_tree and args.ufboot_replicates:
        raise SystemExit("-bb/-B: the ultrafast bootstrap samples the trees "
                         "of a search; drop -te or -bb")
    if args.fix_branch_lengths and not args.user_tree:
        raise SystemExit("-blfix: fixes the branch lengths of a -te tree; "
                         "a search has none to fix")
    m = args.model.upper()
    if m in MODEL_SELECTION or "MERGE" in m:
        raise SystemExit(f"-m {args.model}: model selection is not yet ported "
                         f"to iqtree2_tpu_torch; name a model with -m")


def main(argv=None) -> int:
    parser = build_parser()
    args = parser.parse_args(argv)
    if not args.aln_file:
        print("error: -s ALIGNMENT is required", file=sys.stderr)
        return 2
    refuse_unported(args, parser)
    pr = tpu_cli.params_from_args(args)
    from iqtree2_tpu_torch.analysis import run_analysis
    run_analysis(pr, device=args.device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
