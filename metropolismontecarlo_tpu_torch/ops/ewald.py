"""Ewald summation (counterpart of metropolismontecarlo_tpu/ops/ewald.py).

k-vector table and coefficients, the accuracy-targeted parameter choice
(`tune_parameters`), the structure factor (the eik recurrence, with the
direct sum for pose rows and short k lists), the reciprocal energy,
real-space sum, self and intramolecular terms, and the exact molecular
virials.

Conventions: kappa = kappa_L / box; 0 < |k|^2 < ksq_max in integer
units; energies in Kelvin via COULOMB_FACTOR.  `box` and `kappa` are
tensors of the batch shape (...) of the other arguments (0-d for one
configuration).
"""

import functools
import math

import numpy as np
import torch

from metropolismontecarlo_tpu_torch.ops.pbc import batch_view, min_image
from metropolismontecarlo_tpu_torch.utils.constants import COULOMB_FACTOR

_TWO_OVER_RTPI = 1.1283791670955126  # 2/sqrt(pi)


def make_kvectors(nk=5, ksq_max=27, strict=True):
    """Half-space integer k-vectors: kx in [0, nk], ky/kz in [-nk, nk],
    0 < |k|^2 < ksq_max (<= when not strict); weight 2 for kx > 0.
    Returns (kvecs (K, 3) int32, weights (K,) float64) numpy."""
    ks, ws = [], []
    for kx in range(0, nk + 1):
        for ky in range(-nk, nk + 1):
            for kz in range(-nk, nk + 1):
                k2 = kx * kx + ky * ky + kz * kz
                if k2 == 0:
                    continue
                if (k2 < ksq_max) if strict else (k2 <= ksq_max):
                    ks.append((kx, ky, kz))
                    ws.append(2.0 if kx > 0 else 1.0)
    return np.asarray(ks, dtype=np.int32), np.asarray(ws, dtype=np.float64)


def tune_parameters(box, r_cut, tol=1e-5):
    """Accuracy-targeted Ewald parameters (kappa_L, nk, ksq_max): both
    truncation errors at the relative level tol.  The real-space tail
    goes as erfc(kappa r_cut) and the k-space tail as exp(-k~_max^2 /
    4 kappa^2), so kappa r_cut = sqrt(ln 1/tol) and k~_max = 2 kappa
    sqrt(ln 1/tol), i.e. nk = ceil(box kappa sqrt(ln 1/tol) / pi).
    Returns RunParams' conventions: kappa = kappa_L / box and
    0 < |k|^2 < ksq_max = nk^2 + 1 in integer units."""
    if not (0.0 < tol < 1.0 and r_cut > 0.0 and box > 0.0):
        raise ValueError(f"tune_parameters needs 0 < tol < 1 and positive "
                         f"box and r_cut (box={box}, r_cut={r_cut}, "
                         f"tol={tol})")
    s = float(np.sqrt(np.log(1.0 / tol)))
    kappa = s / r_cut
    nk = int(np.ceil(box * s * kappa / np.pi))
    return kappa * box, nk, nk * nk + 1


def require_full_f32_matmul(t):
    """Raise unless f32 matrix products on t's CUDA device run in full
    f32: TF32 keeps ~3 decimal digits, which corrupts S(k) phases."""
    if t.is_cuda and torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError(
            "torch.backends.cuda.matmul.allow_tf32 must be False: the "
            "structure-factor products need full f32")


def cfac_coeffs(kvecs, weights, kappa, box):
    """w (2 pi / V) exp(-k~^2 / 4 kappa^2) / k~^2 with k~ = 2 pi k / box.
    kvecs (K, 3), weights (K,) tensors -> (..., K)."""
    kappa, box = batch_view(kappa, 1), batch_view(box, 1)
    k2 = torch.sum(kvecs.to(weights.dtype) ** 2, dim=-1)
    kt2 = (2.0 * math.pi / box) ** 2 * k2
    vol = box**3
    return weights * (2.0 * math.pi / vol) * torch.exp(
        -kt2 / (4.0 * kappa**2)) / kt2


def _phases(coords, kvecs, box):
    """(2 pi / box) k . r: coords (..., A, 3) -> (..., A, K)."""
    require_full_f32_matmul(coords)
    kmat = kvecs.to(coords.dtype)
    return (2.0 * math.pi / batch_view(box, 2)) \
        * torch.einsum("...ad,kd->...ak", coords, kmat)


# Fewer atoms than this are pose rows (a few molecules' sites): the direct
# sum, summed over the atoms in order (structure_factor_direct)
POSE_ROWS = 32


def structure_factor_direct(coords, charges, kvecs, box):
    """S(k) = sum_i q_i exp(i k~ . r_i) as (..., K, 2) [re, im], one cos
    and one sin per atom and k-vector.  coords (..., A, 3); charges (A,)
    or (..., A).  Under POSE_ROWS atoms the atom sum is elementwise
    additions in atom order, so each row's value does not depend on the
    batch: the batched product of an einsum picks its algorithm, and so
    its rounding, by the batch size on the card, and a chain-sharded
    plain step would not equal the unsharded one."""
    phase = _phases(coords, kvecs, box)
    q = torch.broadcast_to(charges.to(coords.dtype), phase.shape[:-1])
    if coords.shape[-2] < POSE_ROWS:
        parts = [q[..., None] * torch.cos(phase),
                 q[..., None] * torch.sin(phase)]
        re, im = (functools.reduce(torch.add, x.unbind(-2)) for x in parts)
    else:
        re = torch.einsum("...a,...ak->...k", q, torch.cos(phase))
        im = torch.einsum("...a,...ak->...k", q, torch.sin(phase))
    return torch.stack([re, im], dim=-1)


def _axis_powers(ang, n):
    """exp(i m a) for m = -n..n of every angle a of ang (..., A, 3) as
    (..., A, 3, 2 n + 1) complex, by complex multiplication from
    exp(i a): powers k + 1..2k are powers 1..k times power k, so each
    power is at most ~log2(n) + 1 products away from the one angle (and
    the three axes take ~log2(n) elementwise launches); the negative powers
    are the conjugates."""
    base = torch.polar(torch.ones_like(ang), ang)
    pows = base[..., None]                                  # powers 1..k
    while pows.shape[-1] < n:
        pows = torch.cat([pows, pows * pows[..., -1:]], dim=-1)
    pows = torch.cat([torch.ones_like(base)[..., None], pows[..., :n]],
                     dim=-1)                                # powers 0..n
    m = torch.arange(-n, n + 1, device=ang.device)
    tab = pows[..., m.abs()]
    return torch.where(m < 0, tab.conj(), tab)


# Below this many k-vectors the direct sum's few large launches beat the
# recurrence's ~25 small ones on an H100 (the recurrence is host-launch-
# bound there): scripts/time_structure_factor.py times both on the card,
# in turns, from K 337 (the flagship) to K 3796; they cross between K
# 1152 and 1661 at the recompute chunks' shapes.
RECURRENCE_MIN_K = 1600


def k_bounds(kvecs):
    """(lo, hi) of a host (K, 3) k-vector table: per axis its least and
    largest index, the box of indices the recurrence contracts over."""
    kv = np.asarray(kvecs)
    return tuple(kv.min(0).tolist()), tuple(kv.max(0).tolist())


def structure_factor_recurrence(coords, charges, kvecs, box, bounds=None):
    """S(k) = sum_i q_i exp(i k~ . r_i) as (..., K, 2) [re, im] by the eik
    recurrence: exp(i k~ . r) = ex[kx] ey[ky] ez[kz] with per-axis tables
    of powers of one angle per atom and axis (3 A transcendentals in place
    of K A).  The atom axis is contracted first, per (kx, ky) pair, over
    the whole (kx, ky, kz) box of indices, as one batched product; the K
    k-vectors are then picked from that grid by an index gather.  bounds:
    k_bounds of the host table; without it they are read from kvecs,
    which costs a host sync for a table on the card."""
    require_full_f32_matmul(coords)
    if bounds is None:
        bounds = k_bounds(kvecs.cpu().numpy())
    lo, hi = bounds
    n = max(max(abs(x) for x in lo), max(abs(x) for x in hi))
    ny, nz = hi[1] - lo[1] + 1, hi[2] - lo[2] + 1
    kv = kvecs.to(device=coords.device, dtype=torch.long)
    flat = (kv[:, 0] * ny + kv[:, 1]) * nz + kv[:, 2] \
        - ((lo[0] * ny + lo[1]) * nz + lo[2])
    tab = _axis_powers((2.0 * math.pi / batch_view(box, 2)) * coords, n)
    ex, ey, ez = (tab[..., d, lo[d] + n:hi[d] + n + 1] for d in range(3))
    q = torch.broadcast_to(charges.to(coords.dtype), coords.shape[:-1])
    w = (q[..., None] * ex)[..., :, :, None] * ey[..., :, None, :]
    grid = torch.einsum("...axy,...az->...xyz", w, ez)
    s = grid.flatten(-3)[..., flat]
    return torch.stack([s.real, s.imag], dim=-1)


def structure_factor(coords, charges, kvecs, box, bounds=None):
    """S(k) = sum_i q_i exp(i k~ . r_i) as (..., K, 2) [re, im].
    coords (..., A, 3); charges (A,) or (..., A); kvecs a (K, 3) integer
    tensor; bounds as structure_factor_recurrence.  The recurrence for
    long k lists (K >= RECURRENCE_MIN_K); the direct sum for pose rows
    (A < POSE_ROWS), which the tables would not repay, and for shorter
    lists, where it is the faster on the card."""
    A, K = coords.shape[-2], kvecs.shape[0]
    if A < POSE_ROWS or K < RECURRENCE_MIN_K:
        return structure_factor_direct(coords, charges, kvecs, box)
    return structure_factor_recurrence(coords, charges, kvecs, box, bounds)


def delta_structure_factor(ra_old, ra_new, charges, kvecs, box):
    """S(k) change of one moved molecule, S_new - S_old: ra_old/ra_new
    (..., P, 3), charges (..., P) or (P,) -> (..., K, 2).  O(P K)."""
    return structure_factor(ra_new, charges, kvecs, box) \
        - structure_factor(ra_old, charges, kvecs, box)


def recip_energy(sfac, cfac, factor=COULOMB_FACTOR):
    """factor sum_k cfac_k |S(k)|^2; sfac (..., K, 2), cfac (..., K)."""
    return factor * torch.sum(cfac * torch.sum(sfac * sfac, dim=-1), dim=-1)


def recip_energy_delta(sfac_old, dsfac, cfac, factor=COULOMB_FACTOR):
    """E_fourier(S_old + dS) - E_fourier(S_old), computed stably as
    factor sum_k cfac (2 S_old . dS + |dS|^2)."""
    cross = 2.0 * torch.sum(sfac_old * dsfac, dim=-1) \
        + torch.sum(dsfac * dsfac, dim=-1)
    return factor * torch.sum(cfac * cross, dim=-1)


def real_space_sum(d2, qq, mask, kappa, factor=COULOMB_FACTOR):
    """factor sum qq erfc(kappa r)/r over masked pairs of the trailing
    two axes."""
    kappa = batch_view(kappa, 2)
    d2s = torch.where(mask, d2, torch.ones_like(d2))
    r = torch.sqrt(d2s)
    term = qq * torch.special.erfc(kappa * r) / r
    return factor * torch.sum(torch.where(mask, term, 0.0), dim=(-1, -2))


def real_space_virial(d2, qq, dot_ij_ab, mask, kappa, style, qq_cut=None,
                      factor=COULOMB_FACTOR):
    """Exact molecular virial W = -3V dU/dV of the real-space sum (force
    term plus the kappa = kappa_L/box chain-rule term; Wolf adds the
    shift's kappa term).  dot_ij_ab is r_ij_com . r_ab per pair."""
    kappa = batch_view(kappa, 2)
    d2s = torch.where(mask, d2, torch.ones_like(d2))
    r = torch.sqrt(d2s)
    gauss = torch.exp(-(kappa * kappa) * d2s)
    if style == "bare":
        w = qq * dot_ij_ab / (d2s * r)
    else:
        w = qq * (dot_ij_ab * (torch.special.erfc(kappa * r) / (d2s * r)
                               + kappa * _TWO_OVER_RTPI * gauss / d2s)
                  - kappa * _TWO_OVER_RTPI * gauss)
        if style == "wolf":
            w = w + qq * kappa * _TWO_OVER_RTPI \
                * torch.exp(-(kappa * qq_cut) ** 2)
        elif style != "ewald":
            raise ValueError(style)
    return factor * torch.sum(torch.where(mask, w, 0.0), dim=(-1, -2))


def recip_virial(sfac, cfac, coords, com_of_atom, charges, kvecs, box,
                 factor=COULOMB_FACTOR):
    """Exact molecular virial of the reciprocal sum:
    W = E_recip - 2 factor sum_k cfac_k Im[conj(S_k) T_k] with
    T_k = sum_a q_a (k~ . d_a) exp(i k~ . r_a), d_a the min-imaged offset
    of atom a from its molecule's COM.  coords/com_of_atom (..., A, 3)."""
    d = min_image(coords - com_of_atom, batch_view(box, 2))
    phase = _phases(coords, kvecs, box)
    kdotd = _phases(d, kvecs, box)
    q = torch.broadcast_to(charges.to(coords.dtype), phase.shape[:-1])
    t_re = torch.einsum("...a,...ak->...k", q, kdotd * torch.cos(phase))
    t_im = torch.einsum("...a,...ak->...k", q, kdotd * torch.sin(phase))
    im_sbar_t = sfac[..., 0] * t_im - sfac[..., 1] * t_re
    return recip_energy(sfac, cfac, factor) \
        - 2.0 * factor * torch.sum(cfac * im_sbar_t, dim=-1)


def _intra_pairs(coords_mp, charges_mp, box):
    """Upper-triangle intramolecular d2 and qq: coords_mp (..., M, P, 3)."""
    dr = min_image(coords_mp[..., :, None, :] - coords_mp[..., None, :, :],
                   batch_view(box, 4))
    d2 = torch.clamp_min(torch.sum(dr * dr, dim=-1), 1e-12)
    qq = charges_mp[..., :, None] * charges_mp[..., None, :]
    P = coords_mp.shape[-2]
    iu = torch.triu(torch.ones((P, P), dtype=torch.bool,
                               device=coords_mp.device), diagonal=1)
    return d2, qq, iu


def ewald_intra(coords_mp, charges_mp, kappa, box, factor=COULOMB_FACTOR):
    """NIST-convention intramolecular correction
    -factor sum_mol sum_{i<j} q_i q_j erf(kappa r_ij)/r_ij."""
    d2, qq, iu = _intra_pairs(coords_mp, charges_mp, box)
    r = torch.sqrt(d2)
    erf = 1.0 - torch.special.erfc(batch_view(kappa, 3) * r)
    term = torch.where(iu, qq * erf / r, 0.0)
    return -factor * torch.sum(term, dim=(-1, -2, -3))


def ewald_intra_kappa(coords_mp, charges_mp, kappa, box,
                      factor=COULOMB_FACTOR):
    """kappa dE_intra/dkappa = -factor (2k/sqrt(pi)) sum qq e^{-k^2 r^2}."""
    d2, qq, iu = _intra_pairs(coords_mp, charges_mp, box)
    k3 = batch_view(kappa, 3)
    term = torch.where(iu, qq * torch.exp(-(k3 * k3) * d2), 0.0)
    return -factor * kappa * _TWO_OVER_RTPI \
        * torch.sum(term, dim=(-1, -2, -3))


def overlap_any(d2, qq, mask, d2_overlap=0.5):
    """Hard-overlap veto: any included pair closer than sqrt(d2_overlap)
    with opposite charges (reference `Ewald/ewalds.jl:359-361`).  d2, qq,
    mask (..., P, A) -> (...) bool."""
    bad = (d2 < d2_overlap) & (qq < 0.0) & mask
    return bad.flatten(-2).any(-1)


def ewald_self(charges, kappa, factor=COULOMB_FACTOR):
    """-factor kappa/sqrt(pi) sum q_i^2."""
    return -factor * kappa / math.sqrt(math.pi) \
        * torch.sum(charges * charges, dim=-1)


def surface_dipole(coords, com_of_atom, charges, box):
    """Total dipole M = sum_i q_i (r_i - R_mol(i)) (..., 3), the offsets
    min-imaged: translation-invariant per molecule, hence continuous
    under periodic wrapping.  coords/com_of_atom (..., A, 3)."""
    d = min_image(coords - com_of_atom, batch_view(box, 2))
    q = torch.broadcast_to(charges.to(coords.dtype), d.shape[:-1])
    return torch.sum(q[..., None] * d, dim=-2)


def surface_term(coords, com_of_atom, charges, box, factor=COULOMB_FACTOR):
    """Vacuum-boundary dipole term factor 2 pi/(3V) |M|^2, M the
    surface_dipole."""
    m = surface_dipole(coords, com_of_atom, charges, box)
    return factor * 2.0 * math.pi / (3.0 * box**3) * torch.sum(m * m, dim=-1)
