"""PyTorch/CUDA port of metropolismontecarlo_tpu: chain-parallel rigid-body
Metropolis Monte Carlo for one NVIDIA H100.

The tree mirrors the JAX package (ops/, models/, mc/, io/, utils/); every
module has a counterpart of the same name there, which is the reference
the tests hold this package to.  Hand-written kernels live in ops/cuda/
(sources in csrc/) beside their plain PyTorch versions.  This package
imports torch and numpy only, never jax.
"""

__version__ = "0.1.0"
