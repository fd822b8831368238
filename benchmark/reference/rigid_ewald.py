"""Plain reference for rigid point-site molecules with Lennard-Jones and
Ewald electrostatics: the site coordinates from the centres of mass and
quaternions, the total potential energy and the structure factor S(k) of
each configuration.  It follows the published definitions, written
afresh from the configuration file; it imports nothing of the port.

Conventions (those of the configuration files):

* energies in Kelvin (E / k_B), lengths in Angstrom, charges in e; the
  Coulomb factor e^2 / (4 pi eps0 k_B) from the CODATA 2018 constants;
* the body frame of a water model: O at the origin, the hydrogens at
  (+-r_OH sin(theta/2), 0, r_OH cos(theta/2)), a four-site model's
  charge site M at (0, 0, r_OM); then shifted so that the centre of mass
  (the sites' masses) is at the origin.  Quaternions are (w, x, y, z),
  lab = R(q) body with R the rotation matrix of a unit quaternion;
* the cutoff acts on each site pair of two different molecules, at the
  minimum image, for the LJ and the real-space Ewald terms alike; LJ
  acts between sites with epsilon > 0, Lorentz-Berthelot mixing; the
  long-range LJ tail (8 pi / 3V) N^2 sum eps sig^3 [(sig/rc)^9/3 -
  (sig/rc)^3] when the configuration asks for it;
* Ewald with kappa = kappa_L / L: real space q q erfc(kappa r) / r,
  reciprocal space (2 pi / V) sum_k exp(-k^2 / 4 kappa^2) / k^2 |S(k)|^2
  over the integer vectors n with 0 < |n|^2 < ksq_max, |n_i| <= nk, in
  half space (n_x >= 0; weight 2 for n_x > 0), k = 2 pi n / L, taken in
  the order n_x, then n_y, then n_z ascending; S(k) = sum q exp(i k.r)
  as [re, im]; self -kappa / sqrt(pi) sum q^2; intramolecular -sum over
  site pairs of a molecule of q q erf(kappa r) / r.

`Precision` says in which arithmetic the reference runs: float64, or
TF32 (every operand rounded to TF32's 10 mantissa bits before it is
used, accumulation in float32), the nearest precision below the
float32 that the configurations state with TF32 off, which serves as the
control of the check.
"""

import math

import numpy as np
import torch

_E = 1.602176634e-19          # C
_K_B = 1.380649e-23           # J / K
_EPS0 = 8.8541878128e-12      # F / m
COULOMB_K_A = _E * _E / (4.0 * math.pi * _EPS0) / _K_B * 1.0e10


class Precision:
    """The arithmetic of one evaluation: "float64", or "tf32" (float32
    storage, each operand rounded to TF32 before use)."""

    def __init__(self, name):
        if name not in ("float64", "tf32"):
            raise ValueError(f"precision {name!r}: float64 or tf32")
        self.name = name
        self.dtype = torch.float64 if name == "float64" else torch.float32

    def r(self, x):
        """x rounded to this precision's operand format."""
        if self.name == "float64":
            return x
        bits = x.to(torch.float32).contiguous().view(torch.int32)
        bits = (bits + 0x1000) & ~0x1FFF        # to nearest, 10 mantissa bits
        return bits.view(torch.float32)


def body_frame(model):
    """(P, 3) float64 site positions in the body frame (module docstring)
    from the configuration's model: "geometry" and "sites"."""
    geo = model["geometry"]
    th = math.radians(geo["theta_deg"]) / 2.0
    r = geo["r_oh"]
    pts = [[0.0, 0.0, 0.0], [r * math.sin(th), 0.0, r * math.cos(th)],
           [-r * math.sin(th), 0.0, r * math.cos(th)]]
    if geo["kind"] == "water4":
        pts.append([0.0, 0.0, geo["r_om"]])
    elif geo["kind"] != "water3":
        raise ValueError(f"geometry kind {geo['kind']!r}")
    pts = np.asarray(pts)
    mass = np.asarray([s["mass"] for s in model["sites"]], np.float64)
    if len(mass) != len(pts):
        raise ValueError("one site entry per geometry site")
    return pts - (pts * mass[:, None]).sum(0) / mass.sum()


def rotation(q):
    """(..., 4) quaternions (w, x, y, z) -> (..., 3, 3), lab = R body."""
    w, x, y, z = q.unbind(-1)
    rows = ((w * w + x * x - y * y - z * z, 2 * (x * y - w * z),
             2 * (x * z + w * y)),
            (2 * (x * y + w * z), w * w - x * x + y * y - z * z,
             2 * (y * z - w * x)),
            (2 * (x * z - w * y), 2 * (y * z + w * x),
             w * w - x * x - y * y + z * z))
    return torch.stack([torch.stack(r, -1) for r in rows], -2)


def site_positions(com, quat, body, prec):
    """(B, M, P, 3) lab positions of every site: com (B, M, 3), quat
    (B, M, 4), body (P, 3)."""
    r = prec.r
    com, quat = r(com.to(prec.dtype)), r(quat.to(prec.dtype))
    rot = r(rotation(quat))
    b = r(torch.as_tensor(body, dtype=prec.dtype, device=com.device))
    off = r(torch.sum(rot[:, :, None, :, :] * b[None, None, :, None, :],
                      dim=-1))
    return r(com[:, :, None, :] + off)


def kvectors(nk, ksq_max):
    """(K, 3) int64 vectors n and (K,) float64 weights (module docstring)."""
    ns, ws = [], []
    for nx in range(0, nk + 1):
        for ny in range(-nk, nk + 1):
            for nz in range(-nk, nk + 1):
                n2 = nx * nx + ny * ny + nz * nz
                if 0 < n2 < ksq_max:
                    ns.append((nx, ny, nz))
                    ws.append(2.0 if nx > 0 else 1.0)
    return np.asarray(ns, np.int64), np.asarray(ws, np.float64)


def _site_arrays(model, dev, dtype):
    sites = model["sites"]
    q = torch.tensor([s["charge"] for s in sites], dtype=dtype, device=dev)
    eps = torch.tensor([s.get("epsilon", 0.0) for s in sites],
                       dtype=dtype, device=dev)
    sig = torch.tensor([s.get("sigma", 0.0) for s in sites], dtype=dtype,
                       device=dev)
    return q, eps, sig


def _lrc_sum(eps, sig, r_cut):
    """sum over LJ site pairs of a molecule pair of eps sig^3 [(sig/rc)^9 /
    3 - (sig/rc)^3] (float64, host)."""
    total = 0.0
    for ea, sa in zip(eps.tolist(), sig.tolist()):
        for eb, sb in zip(eps.tolist(), sig.tolist()):
            if ea > 0.0 and eb > 0.0:
                e, s = math.sqrt(ea * eb), 0.5 * (sa + sb)
                sc3 = (s / r_cut) ** 3
                total += e * s ** 3 * (sc3 ** 3 / 3.0 - sc3)
    return total


def evaluate(com, quat, box, active, model, params, prec, rows=8,
             row_block=256):
    """Energy and S(k) of B configurations of one model.

    com (B, M, 3), quat (B, M, 4), box (B,), active (B, M) bool or None
    (all present): only active molecules take part.  params: r_cut,
    kappa_L, nk, ksq_max, use_lrc.  Computed on com's device, `rows`
    configurations at a time, the pair sums in blocks of row_block sites.
    Returns dict(sites (B, M, P, 3), energy (B,), sfac (B, K, 2),
    self_energy (B,): the Ewald self term, the largest term of the sum) in
    prec's dtype."""
    dev = com.device
    dt = prec.dtype
    B, M = com.shape[:2]
    body = body_frame(model)
    P = body.shape[0]
    q_s, eps_s, sig_s = _site_arrays(model, dev, dt)
    if active is None:
        active = torch.ones((B, M), dtype=torch.bool, device=dev)
    nvec, wts = kvectors(int(params["nk"]), int(params["ksq_max"]))
    n_t = torch.as_tensor(nvec, dtype=dt, device=dev)
    w_t = torch.as_tensor(wts, dtype=dt, device=dev)
    rc = float(params["r_cut"])
    lrc = _lrc_sum(eps_s.double().cpu(), sig_s.double().cpu(), rc) \
        if params.get("use_lrc", False) else 0.0
    sites_all, e_all, s_all, self_all = [], [], [], []
    for b0 in range(0, B, rows):
        sl = slice(b0, min(B, b0 + rows))
        x4 = site_positions(com[sl], quat[sl], body, prec)
        e, s, e_self = _energy(x4, active[sl], box[sl].to(dt), q_s, eps_s,
                               sig_s, n_t, w_t, float(params["kappa_L"]),
                               rc, lrc, prec, row_block)
        sites_all.append(x4)
        e_all.append(e)
        s_all.append(s)
        self_all.append(e_self)
    return {"sites": torch.cat(sites_all), "energy": torch.cat(e_all),
            "sfac": torch.cat(s_all), "self_energy": torch.cat(self_all)}


def _energy(x4, active, box, q_s, eps_s, sig_s, n_t, w_t, kappa_l, rc, lrc,
            prec, row_block):
    r = prec.r
    dt, dev = prec.dtype, x4.device
    b, M, P, _ = x4.shape
    A = M * P
    x = x4.reshape(b, A, 3)
    mol = torch.arange(M, device=dev).repeat_interleave(P)
    q = q_s.repeat(M)
    eps = eps_s.repeat(M)
    sig = sig_s.repeat(M)
    on = active.repeat_interleave(P, dim=1)                      # (b, A)
    L = box
    kappa = r(kappa_l / L)
    fac = COULOMB_K_A
    pair = torch.zeros(b, dtype=torch.float64 if dt == torch.float64
                       else torch.float32, device=dev)
    for i0 in range(0, A, row_block):
        i1 = min(A, i0 + row_block)
        dr = r(x[:, i0:i1, None, :] - x[:, None, :, :])
        Lb = L[:, None, None, None]
        dr = r(dr - Lb * torch.round(dr / Lb))
        d2 = r(torch.sum(dr * dr, dim=-1))                      # (b, n, A)
        inside = (mol[i0:i1, None] != mol[None, :])[None] \
            & on[:, i0:i1, None] & on[:, None, :] & (d2 < rc * rc)
        d2s = torch.where(inside, d2, torch.ones_like(d2))
        rr = r(torch.sqrt(d2s))
        qq = r(q[i0:i1, None] * q[None, :])
        coul = r(qq * r(torch.special.erfc(r(kappa[:, None, None] * rr)))
                 / rr)
        e_ij = r(torch.sqrt(eps[i0:i1, None] * eps[None, :]))
        s_ij = r(0.5 * (sig[i0:i1, None] + sig[None, :]))
        s2 = r(r(s_ij * s_ij) / d2s)
        s6 = r(s2 * s2 * s2)
        lj = r(4.0 * e_ij * r(s6 * s6 - s6))
        term = fac * coul + lj
        pair = pair + torch.sum(torch.where(inside, term, 0.0), dim=(1, 2))
    e = 0.5 * pair

    # reciprocal space
    two_pi_l = r(2.0 * math.pi / L)
    phase = r(two_pi_l[:, None, None] * r(x @ n_t.T))            # (b, A, K)
    qa = torch.where(on, q[None, :], 0.0)
    s_re = torch.einsum("ba,bak->bk", qa, r(torch.cos(phase)))
    s_im = torch.einsum("ba,bak->bk", qa, r(torch.sin(phase)))
    k2 = r(two_pi_l[:, None] ** 2 * torch.sum(n_t * n_t, dim=-1)[None, :])
    vol = L ** 3
    cf = r(w_t[None, :] * r(2.0 * math.pi / vol)[:, None]
           * r(torch.exp(-k2 / (4.0 * kappa[:, None] ** 2))) / k2)
    e = e + fac * torch.sum(cf * r(s_re * s_re + s_im * s_im), dim=-1)

    # self and intramolecular terms
    n_mol = active.sum(1).to(dt)
    e_self = -fac * kappa / math.sqrt(math.pi) * n_mol * torch.sum(q_s * q_s)
    e = e + e_self
    intra = torch.zeros_like(e)
    for i in range(P):
        for j in range(i + 1, P):
            rij = r(torch.linalg.vector_norm(
                r(x4[:, :, i, :] - x4[:, :, j, :]), dim=-1))       # (b, M)
            t = r(q_s[i] * q_s[j] * r(torch.special.erf(r(kappa[:, None]
                                                          * rij))) / rij)
            intra = intra + torch.sum(torch.where(active, t, 0.0), dim=1)
    e = e - fac * intra
    if lrc:
        e = e + 8.0 * math.pi / (3.0 * vol) * n_mol * n_mol * lrc
    return e, torch.stack([s_re, s_im], dim=-1), e_self
