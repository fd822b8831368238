"""Activity-mask slot updates (counterpart of
metropolismontecarlo_tpu/utils/activity.py).

The JAX package writes these as one-hot where-selects because a dynamic
bool scatter was once dropped by its TPU compiler.  The semantics are
kept here (a pure function of the mask, any leading batch axes, the slot
index and the flag broadcast over them); the one-hot select is also the
simplest batched form in PyTorch, where every chain picks its own slot.
"""

import torch


def _onehot(n, i, device):
    i = torch.as_tensor(i, device=device)
    return torch.arange(n, device=device) == i[..., None]


def set_slot(active, i, on):
    """active[..., i] |= on; active (..., cap) bool, i and on (...)."""
    on = torch.as_tensor(on, device=active.device)[..., None]
    return torch.where(_onehot(active.shape[-1], i, active.device),
                       on | active, active)


def clear_slot(active, i, off):
    """active[..., i] &= ~off; active (..., cap) bool, i and off (...)."""
    off = torch.as_tensor(off, device=active.device)[..., None]
    return torch.where(_onehot(active.shape[-1], i, active.device),
                       active & ~off, active)


def _mask2(active, b, i):
    dev = active.device
    return _onehot(active.shape[-2], b, dev)[..., :, None] \
        & _onehot(active.shape[-1], i, dev)[..., None, :]


def set_slot2(active, b, i, on):
    """active[..., b, i] |= on for a (..., boxes, cap) activity mask."""
    on = torch.as_tensor(on, device=active.device)[..., None, None]
    return torch.where(_mask2(active, b, i), on | active, active)


def clear_slot2(active, b, i, off):
    """active[..., b, i] &= ~off for a (..., boxes, cap) activity mask."""
    off = torch.as_tensor(off, device=active.device)[..., None, None]
    return torch.where(_mask2(active, b, i), active & ~off, active)


def zero_empty(energy, sfac, active):
    """The carried energy and S(k) of every chain (or box) whose mask
    `active` (..., cap) holds no molecule, set to their exact value 0: an
    empty box has no pair, self or tail term and no charge.  The f32
    kernel routes carry sums of exchange deltas, whose rounding residue
    (~1e-3 K after a few hundred exchanges) would otherwise outlive the
    molecules.  energy (...), sfac (..., K, 2) or None."""
    empty = ~active.any(-1)
    energy = torch.where(empty, torch.zeros_like(energy), energy)
    if sfac is None:
        return energy, None
    return energy, torch.where(empty[..., None, None],
                               torch.zeros_like(sfac), sfac)
