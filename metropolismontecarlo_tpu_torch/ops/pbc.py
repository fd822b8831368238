"""Periodic-boundary geometry for cubic boxes (counterpart of
metropolismontecarlo_tpu/ops/pbc.py).  `box` is a scalar or a tensor
that broadcasts against the displacement."""

import torch


def min_image(dr, box):
    """Minimum-image displacement, wrapped into (-box/2, box/2]."""
    return dr - box * torch.round(dr / box)


def min_image_dist2(ri, rj, box):
    """Squared minimum-image distance between (..., 3) position arrays."""
    dr = min_image(ri - rj, box)
    return torch.sum(dr * dr, dim=-1)


def wrap(r, box):
    """Wrap coordinates into [0, box)."""
    return r - box * torch.floor(r / box)


def pair_min_image(ra, rb, box):
    """All-pairs displacement ra - rb: (..., P, 3), (..., A, 3) ->
    (..., P, A, 3)."""
    return min_image(ra[..., :, None, :] - rb[..., None, :, :], box)


def batch_view(x, n):
    """x of a batch shape (...) viewed as (..., 1 * n), to broadcast a
    per-configuration scalar (box, kappa) over n trailing axes."""
    return x.reshape(tuple(x.shape) + (1,) * n)


# dtype -> (the integer of its width, exponent bias, mantissa bits)
_FLOAT_BITS = {torch.float64: (torch.int64, 1023, 52),
               torch.float32: (torch.int32, 127, 23)}


def cube_root(x):
    """The real cube root of x (sign kept; 0 stays 0), element by element
    from exact operations (frexp, bit shifts) and IEEE arithmetic only,
    so an element's value does not depend on the rest of its tensor: a
    box edge from a volume.  x ** (1/3) on a CPU tensor takes a
    vectorised path on most elements and a scalar one on the last few
    (the length modulo the vector width), whose results differ in the
    last bit, so a chain-sharded run would not equal the unsharded one.
    Newton's iteration from a linear start on the mantissa, within ~1
    ulp of x ** (1/3)."""
    a = x.abs()
    m, e = torch.frexp(a)                          # a = m 2^e, m in [0.5, 1)
    q = torch.div(e, 3, rounding_mode="floor")
    r = e - 3 * q                                  # 0, 1 or 2
    y = m * torch.where(r == 0, 1.0, torch.where(r == 1, 2.0, 4.0)) \
        .to(x.dtype)                               # [0.5, 4), exact
    g = 0.62 + 0.25 * y                            # within 13% of y^(1/3)
    for _ in range(6):                             # e -> e^2 per step
        g = g - (g - y / (g * g)) / 3.0
    ints, bias, shift = _FLOAT_BITS[x.dtype]
    two_q = ((q.to(ints) + bias) << shift).view(x.dtype)    # 2^q, exact
    return torch.where(a > 0.0, torch.sign(x) * g * two_q, x)
