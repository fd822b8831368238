"""Adaptive maximum-displacement controller (counterpart of
metropolismontecarlo_tpu/mc/adjust.py): steer each move type's step
toward a target acceptance, clamped to [0.5, 1.5] x the old step and an
upper bound.  Adaptation breaks detailed balance, so it runs during
equilibration only (the driver's `adjust` flag)."""

import torch


def adjust_dmax(d_max, n_acc, n_att, target, upper):
    """d_max' = clip(d_max * (n_acc/n_att)/target, 0.5 d_max, 1.5 d_max),
    at most `upper`; unchanged where n_att == 0.  (C,) tensors; upper a
    float or (C,) tensor."""
    ratio = n_acc.to(d_max.dtype) / torch.clamp_min(n_att.to(d_max.dtype),
                                                     1.0)
    new = torch.minimum(torch.maximum(d_max * ratio / target, 0.5 * d_max),
                        1.5 * d_max)
    new = torch.minimum(new, torch.as_tensor(upper, dtype=d_max.dtype,
                                             device=d_max.device))
    return torch.where(n_att > 0, new, d_max)
