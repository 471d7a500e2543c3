"""Distributed search (multihost.py), the pattern-sharded likelihood
(shard.py) and its n-rank dry run (dryrun.py) over torch.distributed
(counterpart of iqtree2_tpu/parallel/)."""
