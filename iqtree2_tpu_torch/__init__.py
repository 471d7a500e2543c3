"""iqtree2_tpu_torch: the PyTorch/CUDA port of iqtree2_tpu for NVIDIA Hopper.

The JAX package ``iqtree2_tpu`` stays the reference; this package
re-implements its likelihood path with torch tensors and three hand-written
CUDA kernels (ops/kernels.py, csrc/pruning.cu), and keeps its own copies of
the host modules it needs (alignment, models, tree schedule, I/O,
parsimony, UFBoot, host optimizers; each copy names its origin). It imports
torch, never jax, and nothing of iqtree2_tpu.

Ported so far, for reversible models: the fixed-topology model fit
(``python -m iqtree2_tpu_torch -s ALN -m MODEL -te TREE``) and the
stochastic tree search with ultrafast bootstrap
(``python -m iqtree2_tpu_torch -s ALN -m MODEL [-bb N]``), both with the
joint model fit of model/torchfit.py.
"""

__version__ = "0.1.0"
