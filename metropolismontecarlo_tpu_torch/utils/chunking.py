"""Chunked loop over the chain axis (counterpart of chunked_vmap): bounds
the peak memory of O(A^2) work such as full-energy recomputes."""

import torch

from metropolismontecarlo_tpu_torch.utils.profiling import span


def chunked_map(fn, chunk, *tensors):
    """fn applied to consecutive groups of `chunk` rows of the leading
    axis of *tensors (the last group may be shorter), each group inside a
    `chunk` span of its rows.  fn takes batched tensors and returns a
    tuple of batched tensors; each element is concatenated over the
    groups."""
    n = tensors[0].shape[0]
    step = max(1, int(chunk))
    parts = []
    for i in range(0, n, step):
        with span("chunk", min(step, n - i), sync=False):
            parts.append(fn(*(t[i:i + step] for t in tensors)))
    return tuple(torch.cat(col, dim=0) for col in zip(*parts))
