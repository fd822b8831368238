"""The least time a kernel launch could take on one H100, from the shapes
of the work it does: a frozen copy of the port's smoke-test arithmetic
(chip_smoke.py `sweep_bound`, `gibbs_bound`, `k_pose_ops`, `_bound`, the
OPS_* counts and the published peaks), kept here so that it cannot move
with the program.  Two changes from that copy: the bytes count the real
atoms of a configuration, not the padded width of the port's layout, so
the bound reads the same work whatever implements it; and a species
block is described by its counts (`Block`), read from the configuration,
not by the port's kernel tables.

A roofline share is this least time over the device time of the launches
that did the work, with the card's power limit printed beside it.
`sweep_bound` keeps only the copy's fixed-N path, the one the cells run;
a later cell of another ensemble adds its bound in a file of its own,
copied from chip_smoke's arithmetic.  `recompute_bound` (no counterpart
in chip_smoke) counts the full recompute of the energy and S(k) that a
block end and a volume move make, for the block's share of the peak.
"""

import dataclasses

import torch

# H100 SXM published peaks (NVIDIA data sheet, dense, at 700 W)
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_OPS_PER_S = 67e12
# f32 operations counted per distance and per pair term: a minimum-image
# distance (3 sub, 3 x mul/rint/fma, 5 for d^2, floor, rsqrt, cutoff test)
# once per (atom lane, pose) to the pose's centre and once per (atom lane,
# site) for the atoms within the pose's reach (reach_fraction: the others
# cannot hold a pair inside the cutoff); the LJ term (1/d^2, s^2, s^6,
# s^12 - s^6, eps, accumulate) and the Coulomb term (r, kappa r, erfc as
# ~12, / r, q q, accumulate) for pairs inside the cutoff only
OPS_GEOMETRY, OPS_LJ, OPS_COULOMB = 20, 8, 17
# k-space by per-site eik tables: per charged site of a pose three rows
# e^{i 2 pi n x / L}, |n| <= nk, each one sincos (the phase and its
# reduction 5, sincospif ~8) and nk complex products (4 each); per
# k-vector and charged site two complex products and the accumulation (8);
# per k-vector and move the energy cross term (8)
OPS_SINCOS, OPS_CMUL, OPS_K_SITE, OPS_K_MOVE = 13, 4, 8, 8
# per candidate slot of a deletion pick (Gibbs transfers): 10 Philox
# rounds of two 32 x 32 products (high and low words), three xors and two
# key additions
OPS_PHILOX = 90


@dataclasses.dataclass(frozen=True)
class Block:
    """One species block of a configuration: P sites per molecule, M
    molecules (slots), n_lj sites with Lennard-Jones, n_q charged sites,
    the Coulomb style and the Ewald nk."""
    P: int
    M: int
    n_lj: int
    n_q: int
    coulomb: str
    nk: int


def block_of(model, n_mol, params):
    """The Block of a configuration's model ("sites": charge, epsilon) of
    n_mol molecules under params (coulomb, nk)."""
    sites = model["sites"]
    coulomb = params["coulomb"]
    return Block(P=len(sites), M=int(n_mol),
                 n_lj=sum(1 for s in sites if s.get("epsilon", 0.0) > 0.0),
                 n_q=sum(1 for s in sites if s["charge"] != 0.0),
                 coulomb=coulomb, nk=int(params.get("nk", 0)))


def bound(nbytes, ops):
    """(least ms, "bytes" | "operations")."""
    t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S, ops / PEAK_F32_OPS_PER_S
    return (1e3 * max(t_bytes, t_ops),
            "bytes" if t_bytes >= t_ops else "operations")


def k_pose_ops(K, nk, sites):
    """The operations of one pose's S(k) row over K k-vectors from its
    charged sites' eik tables: per site three table rows, then per
    k-vector and site two complex products."""
    return sites * (3 * (OPS_SINCOS + nk * OPS_CMUL) + K * OPS_K_SITE)


def sweep_bound(blocks, C, K, frac, near):
    """The least time (ms) one sweep of C chains could take, and what sets
    it: each input and output moved once against the operations the pair
    and k-space sums need: per atom lane and pose one distance to the
    pose's centre, the site distances for the share near[b] of block b's
    lanes within the pose's reach and the terms for the share frac inside
    the cutoff (chip_smoke's fixed-N path: no activity mask, exchanges,
    Widom ghosts, TMMC or slabs)."""
    M = sum(b.M for b in blocks)
    A = sum(b.M * b.P for b in blocks)
    nbytes = 4 * C * (2 * 3 * A + 2 * 7 * M + 2 * 2 * K + 10 * M + 10)
    ops = 0.0
    for i, t in enumerate(blocks):
        lj = t.n_lj
        qf = t.n_q if t.coulomb != "none" else 0
        sites = near[i] * t.P * OPS_GEOMETRY + frac * (lj * OPS_LJ
                                                        + qf * OPS_COULOMB)
        per_pose = (A - t.P) * (OPS_GEOMETRY + sites)
        k_move = 2 * k_pose_ops(K, t.nk, qf) + K * OPS_K_MOVE \
            if t.coulomb == "ewald" else 0
        ops += C * t.M * (2 * per_pose + k_move)
    return bound(nbytes, ops)


def gibbs_bound(t, C, K, n_box, frac, near, n_exch, n_move=None):
    """The least time (ms) of one Gibbs launch of C chains, and what sets
    it: the chain state in and out once (both boxes' t.M slots and their
    atoms), the uniforms and constants read once, against the operations
    the pair and k-space sums need: each active slot of box b moves once,
    its old and new poses summed against the other active atoms of box b
    and every k-vector; each transfer sums one pose against each box (the
    source without the candidate) with two S(k) rows, and scores the
    source's active slots with Philox.  n_box (C, 2) the active counts;
    frac[b], near[b] box b's shares inside the cutoff and within reach;
    n_move (C, 2) those of the launch's block when the boxes hold other
    species too (default n_box)."""
    lj = t.n_lj
    qf = t.n_q if t.coulomb != "none" else 0
    ewald = t.coulomb == "ewald"
    m_off, A_off = t.M, t.M * t.P
    # per chain: x, y, z and activity of both boxes' atoms, COM (3),
    # quaternion (4) and activity of both boxes' slots, both S(k) rows
    state = 8 * A_off + 16 * m_off + 4 * K
    nbytes = 4 * C * (2 * state + 2 * t.M * 10 + 8 * n_exch + 4 + 4 + 8)
    n = n_box.double()
    nm = n if n_move is None else n_move.double()
    ops = 0.0
    for b in range(2):
        c_pair = OPS_GEOMETRY + near[b] * t.P * OPS_GEOMETRY + frac[b] * (
            lj * OPS_LJ + qf * OPS_COULOMB)
        pairs = float((nm[:, b] * (n[:, b] - 1.0)).sum()) * t.P * c_pair
        k_move = 2 * k_pose_ops(K, t.nk, qf) + K * OPS_K_MOVE if ewald \
            else 0
        ops += 2 * pairs + float(nm[:, b].sum()) * k_move
    f_mix, n_mix = 0.5 * (frac[0] + frac[1]), 0.5 * (near[0] + near[1])
    c_pair = OPS_GEOMETRY + n_mix * t.P * OPS_GEOMETRY + f_mix * (
        lj * OPS_LJ + qf * OPS_COULOMB)
    k_pose = k_pose_ops(K, t.nk, qf) + K * OPS_K_MOVE if ewald else 0
    n_tot = float(n.sum(1).mean())
    ops += C * n_exch * ((n_tot - 1.0) * t.P * c_pair + 2 * k_pose
                         + 0.5 * float(nm.sum(1).mean()) * OPS_PHILOX)
    return bound(nbytes, ops)


def recompute_bound(t, boxes, K):
    """The least time (ms) of one recompute of the energy and S(k) of a
    batch of boxes of block t's molecules, and what sets it: boxes is a
    list of (n_mol (B,) the molecules of each box, frac the share of their
    site pairs inside the cutoff).  Per box, each unordered pair of sites
    of different molecules one distance and, inside the cutoff, its terms
    (LJ between LJ sites, Coulomb between charged ones); per molecule its
    S(k) row and per box the reciprocal energy over the K k-vectors;
    each box's atoms read and its energy and S(k) written once."""
    qf = t.n_q if t.coulomb != "none" else 0
    ops = nbytes = 0.0
    for n_mol, frac in boxes:
        n = n_mol.double()
        A = n * t.P
        pairs = float((A * (A - t.P)).sum()) / 2.0
        terms = frac * ((t.n_lj / t.P) ** 2 * OPS_LJ
                        + (qf / t.P) ** 2 * OPS_COULOMB)
        ops += pairs * (OPS_GEOMETRY + terms)
        if t.coulomb == "ewald":
            ops += float(n.sum()) * k_pose_ops(K, t.nk, qf) \
                + len(n) * K * OPS_K_MOVE
        nbytes += 4.0 * float((3.0 * A + 1.0 + 2.0 * K).sum())
    return bound(nbytes, ops)


def _min_image(d, L):
    return d - L * torch.round(d / L)


def cutoff_fraction(sites, box, r_cut, active=None, n=4):
    """Share of the site pairs of different molecules (both active) within
    r_cut, pooled over the first n configurations.  sites (B, M, P, 3),
    box (B,), active (B, M) or None."""
    inside = total = 0.0
    for c in range(min(n, sites.shape[0])):
        M, P = sites.shape[1:3]
        on_m = torch.ones(M, dtype=torch.bool, device=sites.device) \
            if active is None else active[c].bool()
        x = sites[c][on_m].reshape(-1, 3)
        mol = torch.arange(int(on_m.sum()), device=x.device) \
            .repeat_interleave(P)
        d = _min_image(x[:, None, :] - x[None, :, :], box[c])
        other = mol[:, None] != mol[None, :]
        inside += float(((d * d).sum(-1) < r_cut ** 2)[other].sum())
        total += float(other.sum())
    return inside / max(total, 1.0)


def reach_fraction(sites, com, box, r_cut, active=None, n=4):
    """Share of the pairs (molecule m, site j of another molecule), both
    active, whose minimum-image distance from m's centre com[m] is below
    m's reach: r_cut plus the largest distance of m's sites from that
    centre (only these sites can hold a site pair inside the cutoff), from
    n configurations spread over the batch.  sites (B, M, P, 3), com
    (B, M, 3), box (B,), active (B, M) or None."""
    B, M, P = sites.shape[:3]
    inside = total = 0.0
    for c in sorted({round(i * (B - 1) / max(n - 1, 1)) for i in range(n)}):
        on_m = torch.ones(M, dtype=torch.bool, device=sites.device) \
            if active is None else active[c].bool()
        L = box[c]
        x = sites[c].reshape(-1, 3)
        mol = torch.arange(M, device=x.device).repeat_interleave(P)
        on_a = on_m[mol]
        rad = _min_image(sites[c] - com[c][:, None, :], L).norm(dim=-1) \
            .amax(dim=1)                                        # (M,)
        d = _min_image(x[None, :, :] - com[c][:, None, :], L)    # (M, A, 3)
        near = (d * d).sum(-1) < ((r_cut + rad) ** 2)[:, None]
        pair = on_m[:, None] & on_a[None, :] \
            & (mol[None, :] != torch.arange(M, device=x.device)[:, None])
        inside += float((near & pair).sum())
        total += float(pair.sum())
    return inside / max(total, 1.0)
