"""Chunked loop over the chain axis (counterpart of chunked_vmap): bounds
the peak memory of O(A^2) work such as full-energy recomputes."""

import torch


def chunked_map(fn, chunk, *tensors):
    """fn applied to consecutive groups of `chunk` rows of the leading
    axis of *tensors (the last group may be shorter).  fn takes batched
    tensors and returns a tuple of batched tensors; each element is
    concatenated over the groups."""
    n = tensors[0].shape[0]
    parts = [fn(*(t[i:i + chunk] for t in tensors))
             for i in range(0, n, max(1, int(chunk)))]
    return tuple(torch.cat(col, dim=0) for col in zip(*parts))
