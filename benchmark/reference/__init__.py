"""Plain references of the benchmark's configurations, found by the name
a configuration file gives under "reference".  They import torch, numpy
and math only: nothing of the port, nothing of the JAX package."""
