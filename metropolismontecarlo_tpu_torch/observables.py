"""Observables (counterpart of metropolismontecarlo_tpu/observables.py):
radial distribution functions, block averages and blocking analysis,
the dielectric constant, S(k), fluctuation formulas, Kirkwood-Buff
integrals and the heat of vaporization.

The accumulators take states on any device and work there, chunked over
chains (`chunk` chains at a time, as the JAX package's chunked_vmap);
their running sums are float64 (integer counts for the histograms) and
their results numpy.
"""

import numpy as np
import torch

from metropolismontecarlo_tpu_torch.ops.ewald import (
    k_bounds,
    make_kvectors,
    structure_factor,
    surface_dipole,
)
from metropolismontecarlo_tpu_torch.utils.constants import COULOMB_FACTOR


def _per_device(cache, device, build):
    """build(device) once per device (index tensors and tables)."""
    key = str(device)
    if key not in cache:
        cache[key] = build(device)
    return cache[key]


def _pair_bins(coords, box, ii, jj, keep, r_max, n_bins):
    """Histogram bins of the (Ni, Nj) site pairs of a chunk: coords
    (c, 3, A_pad), box (c,), keep (c or 1, Ni, Nj) -> (c, Ni, Nj) bin
    indices, n_bins where a pair is dropped."""
    ri = coords[:, :, ii]
    rj = coords[:, :, jj]
    dr = ri[:, :, :, None] - rj[:, :, None, :]
    b = box.reshape(-1, 1, 1, 1)
    dr = dr - b * torch.round(dr / b)
    r = torch.sqrt(torch.clamp_min(torch.sum(dr * dr, 1), 1e-12))
    keep = keep & (r < r_max)
    bins = torch.clamp((r * (n_bins / r_max)).to(torch.int64), 0,
                       n_bins - 1)
    return torch.where(keep, bins, torch.full_like(bins, n_bins))


class RDFAccumulator:
    """RDF between two atom-type selections, pooled over chains:

        g(r) = <n(r)> / (N_i rho_j 4 pi r^2 dr)

    accumulated as integer bin counts on the state's device."""

    def __init__(self, system, type_i, type_j, r_max, n_bins=200, chunk=8):
        tid = system.flat(system.type_ids)
        self.idx_i = np.nonzero(tid == type_i)[0]
        self.idx_j = np.nonzero(tid == type_j)[0]
        mol = system.atom_mol_slot[0]
        self.mol_i = mol[self.idx_i]
        self.mol_j = mol[self.idx_j]
        self.same_type = type_i == type_j
        self.r_max = float(r_max)
        self.n_bins = int(n_bins)
        self.chunk = int(chunk)
        self.hist = np.zeros(self.n_bins, np.int64)
        self.n_samples = 0
        self._vol_sum = 0.0
        self._dev = {}

    def _tables(self, device):
        def t(a):
            return torch.as_tensor(np.asarray(a), device=device)

        inter = t(self.mol_i)[:, None] != t(self.mol_j)[None, :]
        return t(self.idx_i), t(self.idx_j), inter[None]

    def update(self, state):
        coords, box = state.coords, state.box
        ii, jj, inter = _per_device(self._dev, coords.device, self._tables)
        hist = torch.zeros(self.n_bins + 1, dtype=torch.int64,
                           device=coords.device)
        for c0 in range(0, coords.shape[0], self.chunk):
            bins = _pair_bins(coords[c0:c0 + self.chunk],
                              box[c0:c0 + self.chunk], ii, jj, inter,
                              self.r_max, self.n_bins)
            hist += torch.bincount(bins.reshape(-1),
                                   minlength=self.n_bins + 1)
        self.hist += hist[:self.n_bins].cpu().numpy()
        self.n_samples += coords.shape[0]
        self._vol_sum += float(torch.sum(box.double() ** 3))

    def result(self):
        """(r_centres, g_r) numpy arrays."""
        dr = self.r_max / self.n_bins
        r = (np.arange(self.n_bins) + 0.5) * dr
        if self.n_samples == 0:
            return r, np.zeros(self.n_bins)
        vol_mean = self._vol_sum / self.n_samples
        rho_j = len(self.idx_j) / vol_mean
        shell = 4.0 * np.pi * r**2 * dr
        norm = self.n_samples * len(self.idx_i) * rho_j * shell
        return r, self.hist / np.maximum(norm, 1e-300)


class MaskedRDFAccumulator:
    """RDF under a per-chain activity mask (fluctuating N, e.g. the muVT
    and Gibbs apps), normalised by the accumulated sum_c n_i n_j / V:

        g(r) = sum_c hist_c(r) / (4 pi r^2 dr sum_c n_i(c) n_j(c) / V(c))

    which is RDFAccumulator's normalisation for a constant mask."""

    def __init__(self, system, type_i, type_j, r_max, n_bins=200, chunk=8):
        tid = system.flat(system.type_ids)
        self.idx_i = np.nonzero(tid == type_i)[0]
        self.idx_j = np.nonzero(tid == type_j)[0]
        mol = system.atom_mol_slot[0]
        self.mol_i, self.mol_j = mol[self.idx_i], mol[self.idx_j]
        self.r_max = float(r_max)
        self.n_bins = int(n_bins)
        self.chunk = int(chunk)
        self.hist = np.zeros(self.n_bins, np.int64)
        self._norm = 0.0
        self._dev = {}

    _tables = RDFAccumulator._tables

    def update(self, coords, box, atom_ok):
        """coords (C, 3, A_pad), box (C,), atom_ok (C, A_pad) bool."""
        ii, jj, inter = _per_device(self._dev, coords.device, self._tables)
        hist = torch.zeros(self.n_bins + 1, dtype=torch.int64,
                           device=coords.device)
        for c0 in range(0, coords.shape[0], self.chunk):
            sl = slice(c0, c0 + self.chunk)
            oki, okj = atom_ok[sl][:, ii], atom_ok[sl][:, jj]
            keep = inter & oki[:, :, None] & okj[:, None, :]
            bins = _pair_bins(coords[sl], box[sl], ii, jj, keep,
                              self.r_max, self.n_bins)
            hist += torch.bincount(bins.reshape(-1),
                                   minlength=self.n_bins + 1)
            norm = oki.sum(1).double() * okj.sum(1).double() \
                / box[sl].double() ** 3
            self._norm += float(norm.sum())
        self.hist += hist[:self.n_bins].cpu().numpy()

    def result(self):
        dr = self.r_max / self.n_bins
        r = (np.arange(self.n_bins) + 0.5) * dr
        if self._norm == 0.0:
            return r, np.zeros(self.n_bins)
        shell = 4.0 * np.pi * r**2 * dr
        return r, self.hist / (shell * self._norm)


class BlockAverager:
    """Running block statistics on the host."""

    def __init__(self):
        self.blocks = []

    def add(self, **metrics):
        self.blocks.append(dict(metrics))

    def _vals(self, key, skip):
        return [b[key] for b in self.blocks[skip:] if key in b]

    def mean(self, key, skip=0):
        vals = self._vals(key, skip)
        return float(np.mean(vals)) if vals else float("nan")

    def sem(self, key, skip=0):
        vals = self._vals(key, skip)
        if len(vals) < 2:
            return float("nan")
        return float(np.std(vals, ddof=1) / np.sqrt(len(vals)))

    def sem_blocking(self, key, skip=0):
        """blocking_analysis's sem of the block series; the naive sem
        below 32 entries."""
        vals = self._vals(key, skip)
        if len(vals) < 32:
            return self.sem(key, skip)
        return blocking_analysis(vals)["sem"]


def blocking_analysis(series, min_blocks=16):
    """Flyvbjerg-Petersen blocking: the autocorrelation-aware standard
    error of the mean of a correlated series.  The series is pair-averaged
    level by level; the plateau is the first level whose successor grows
    by no more than its own sampling noise,
    s_{k+1} <= s_k (1 + 1 / sqrt(2 (n_{k+1} - 1))).

    Returns dict(mean, sem_naive, sem, tau, n_levels), tau the integrated
    autocorrelation time sem / sem_naive implies (0.5 for white noise,
    floored there).  Analyse per-chain series per chain."""
    x = np.asarray(series, np.float64).ravel()
    n = x.size
    if n < 2 * min_blocks:
        raise ValueError(f"need >= {2 * min_blocks} samples, got {n}")
    mean = float(x.mean())
    sem_naive = float(x.std(ddof=1) / np.sqrt(n))
    levels = []
    while x.size >= min_blocks:
        levels.append((x.size, float(x.std(ddof=1) / np.sqrt(x.size))))
        x = 0.5 * (x[: x.size // 2 * 2: 2] + x[1: x.size // 2 * 2: 2])
    sem = levels[-1][1]
    for (_, s_k), (n_k1, s_k1) in zip(levels, levels[1:]):
        if s_k1 <= s_k * (1.0 + 1.0 / np.sqrt(2.0 * (n_k1 - 1))):
            sem = s_k
            break
    tau = max(0.5, 0.5 * (sem / sem_naive) ** 2) if sem_naive > 0 else 0.5
    return dict(mean=mean, sem_naive=sem_naive, sem=sem, tau=tau,
                n_levels=len(levels))


def dielectric_constant(m2_mean, m_mean, vol_mean, temp):
    """Static dielectric constant from total-dipole fluctuations under
    tinfoil boundary conditions,

        eps = 1 + (4 pi / 3) factor (<M^2> - |<M>|^2) / (V T)

    M in e Angstrom, V in Angstrom^3, T in K, factor = COULOMB_FACTOR
    (Neumann, Mol. Phys. 50, 841 (1983))."""
    m_mean = np.asarray(m_mean, np.float64)
    dm2 = float(m2_mean) - float(np.dot(m_mean, m_mean))
    return 1.0 + (4.0 * np.pi / 3.0) * COULOMB_FACTOR * dm2 / (
        float(vol_mean) * float(temp))


class DipoleAccumulator:
    """Total-dipole moments pooled over chains and samples, for the
    dielectric constant and the Kirkwood factor g_K = <M^2> / (N mu^2).
    M is the sum of molecular dipoles (ops/ewald.py surface_dipole),
    continuous under periodic wrapping.  Pools all chains: equal
    temperatures only."""

    def __init__(self, system, chunk=8):
        self.system = system
        self.chunk = int(chunk)
        body = np.asarray(system.body, np.float64)
        qs = np.asarray(system.charges, np.float64)
        mu_mol = np.linalg.norm((qs[..., None] * body).sum(axis=1), axis=-1)
        self.n_polar = int(np.sum(mu_mol > 1e-12))
        self.mu2_sum = float(np.sum(mu_mol**2))
        self.m_sum = np.zeros(3)
        self.m2_sum = 0.0
        self.n_samples = 0
        self._vol_sum = 0.0
        self._temp_sum = 0.0
        self._dev = {}

    def _tables(self, device):
        s = self.system
        A = s.n_atoms
        return (torch.as_tensor(np.array(s.flat(s.charges)), device=device),
                torch.as_tensor(np.array(s.mol_of_atom_padded[:A]),
                                device=device))

    def update(self, state):
        charges, mol_id = _per_device(self._dev, state.coords.device,
                                      self._tables)
        A = self.system.n_atoms
        ms, m2s = 0.0, 0.0
        for c0 in range(0, state.coords.shape[0], self.chunk):
            sl = slice(c0, c0 + self.chunk)
            coords = state.coords[sl, :, :A].transpose(1, 2)
            m = surface_dipole(coords, state.com[sl][:, mol_id],
                               charges.to(coords.dtype), state.box[sl])
            ms = ms + torch.sum(m, 0, dtype=torch.float64)
            m2s = m2s + torch.sum(torch.sum(m * m, -1), dtype=torch.float64)
        self.m_sum += np.asarray(ms.cpu())
        self.m2_sum += float(m2s)
        self.n_samples += state.coords.shape[0]
        self._vol_sum += float(torch.sum(state.box.double() ** 3))
        self._temp_sum += float(torch.sum(state.temp.double()))

    def result(self):
        """dict(epsilon, g_kirkwood, m_mean (3,), m2_mean, n_samples)."""
        if self.n_samples == 0:
            return dict(epsilon=float("nan"), g_kirkwood=float("nan"),
                        m_mean=np.zeros(3), m2_mean=float("nan"),
                        n_samples=0)
        n = self.n_samples
        m_mean = self.m_sum / n
        m2_mean = self.m2_sum / n
        eps = dielectric_constant(m2_mean, m_mean, self._vol_sum / n,
                                  self._temp_sum / n)
        g_k = (m2_mean / self.mu2_sum) if self.mu2_sum > 0 else float("nan")
        return dict(epsilon=eps, g_kirkwood=g_k, m_mean=m_mean,
                    m2_mean=m2_mean, n_samples=n)


class StructureFactorAccumulator:
    """Static structure factor of one atom-type selection (all atoms when
    type_sel is None), pooled over chains, on the box-commensurate grid,

        S(k) = <|sum_j exp(i k.r_j)|^2> / N_sel,   k = (2 pi / L) n,

    averaged over the shells |n|^2 <= n_max^2 with every |n_i| <= n_max,
    through ops/ewald.py structure_factor with unit weights.  The reported k uses the running mean box edge."""

    def __init__(self, system, type_sel=None, n_max=6, chunk=8):
        tid = np.asarray(system.flat(system.type_ids))
        sel = (np.arange(system.n_atoms) if type_sel is None
               else np.nonzero(tid == type_sel)[0])
        if len(sel) == 0:
            raise ValueError(f"no atoms of type {type_sel}")
        self.n_sel = len(sel)
        self.chunk = int(chunk)
        kvecs, kw = make_kvectors(n_max, n_max * n_max, strict=False)
        keep = np.max(np.abs(kvecs), axis=1) <= n_max
        self._kvecs, self._kw = kvecs[keep], kw[keep]
        self._bounds = k_bounds(self._kvecs)
        self.ksq = np.sum(self._kvecs.astype(np.int64) ** 2, axis=1)
        self.shells = np.unique(self.ksq)
        self._sel = sel
        self.rho2_sum = np.zeros(len(self._kvecs))
        self.n_samples = 0
        self._box_sum = 0.0
        self._dev = {}

    def _tables(self, device):
        return (torch.as_tensor(self._sel, device=device),
                torch.as_tensor(self._kvecs, device=device))

    def update(self, state):
        idx, kv = _per_device(self._dev, state.coords.device, self._tables)
        acc = 0.0
        for c0 in range(0, state.coords.shape[0], self.chunk):
            sl = slice(c0, c0 + self.chunk)
            r = state.coords[sl][:, :, idx].transpose(1, 2)
            s = structure_factor(r, torch.ones((), dtype=r.dtype,
                                               device=r.device),
                                 kv, state.box[sl], self._bounds)
            acc = acc + torch.sum(torch.sum(s * s, -1), 0,
                                  dtype=torch.float64)
        self.rho2_sum += np.asarray(acc.cpu())
        self.n_samples += state.coords.shape[0]
        self._box_sum += float(torch.sum(state.box.double()))

    def result(self):
        """(k (S,), S(k) (S,)) shell averages, numpy."""
        l_mean = (self._box_sum / self.n_samples) if self.n_samples else 1.0
        k_out = 2.0 * np.pi / l_mean * np.sqrt(self.shells.astype(np.float64))
        if self.n_samples == 0:
            return k_out, np.zeros(len(self.shells))
        s_k = self.rho2_sum / (self.n_samples * self.n_sel)
        out = np.zeros(len(self.shells))
        for i, sh in enumerate(self.shells):
            m = self.ksq == sh
            out[i] = np.average(s_k[m], weights=self._kw[m])
        return k_out, out


def _host(x):
    return np.asarray(x.detach().cpu().double() if torch.is_tensor(x)
                      else x, np.float64)


class NPTFluctuations:
    """Volume and energy fluctuations pooled over equal-(T, P) chains:

        kappa_T = (<V^2> - <V>^2) / (T <V>)
        alpha_P = (<V E> - <V><E> + P (<V^2> - <V>^2)) / (T^2 <V>)
        cp_conf = <dH^2> / T^2,  H = E + P V

    (kB = 1, E in K, P in K/A^3).  The ideal gas gives kappa_T = 1/P and
    alpha_P = 1/T exactly."""

    def __init__(self, pressure):
        self.pressure = float(pressure)
        self.n = 0
        self.s = dict(v=0.0, v2=0.0, e=0.0, ve=0.0, h2=0.0, h=0.0, t=0.0)

    def update(self, state):
        v = _host(state.box) ** 3
        e = _host(state.energy)
        h = e + self.pressure * v
        self.n += v.shape[0]
        s = self.s
        s["v"] += float(v.sum())
        s["v2"] += float((v * v).sum())
        s["e"] += float(e.sum())
        s["ve"] += float((v * e).sum())
        s["h"] += float(h.sum())
        s["h2"] += float((h * h).sum())
        s["t"] += float(_host(state.temp).sum())

    def result(self):
        """dict(kappa_T, alpha_P, cp_conf, v_mean, n_samples)."""
        if self.n < 2:
            return dict(kappa_T=float("nan"), alpha_P=float("nan"),
                        cp_conf=float("nan"), v_mean=float("nan"),
                        n_samples=self.n)
        n, s = self.n, self.s
        t = s["t"] / n
        v_mean = s["v"] / n
        var_v = s["v2"] / n - v_mean**2
        cov_ve = s["ve"] / n - v_mean * (s["e"] / n)
        var_h = s["h2"] / n - (s["h"] / n) ** 2
        alpha = (cov_ve + self.pressure * var_v) / (t * t * v_mean)
        return dict(kappa_T=var_v / (t * v_mean), alpha_P=alpha,
                    cp_conf=var_h / (t * t), v_mean=v_mean, n_samples=n)


def excess_heat_capacity(e2_mean, e_mean, temp):
    """C_v,ex / kB = (<E^2> - <E>^2) / T^2 (energies in K)."""
    return (float(e2_mean) - float(e_mean) ** 2) / float(temp) ** 2


class EnergyFluctuations:
    """First and second moments of the carried total energy, pooled over
    equal-temperature chains, for C_v,ex."""

    def __init__(self):
        self.e_sum = 0.0
        self.e2_sum = 0.0
        self.n_samples = 0
        self._temp_sum = 0.0

    def update(self, state):
        e = _host(state.energy)
        self.e_sum += float(e.sum())
        self.e2_sum += float((e * e).sum())
        self.n_samples += e.shape[0]
        self._temp_sum += float(_host(state.temp).sum())

    def result(self):
        if self.n_samples < 2:
            return dict(cv_excess=float("nan"), e_mean=float("nan"),
                        e2_mean=float("nan"), n_samples=self.n_samples)
        n = self.n_samples
        e_mean = self.e_sum / n
        e2_mean = self.e2_sum / n
        return dict(cv_excess=excess_heat_capacity(e2_mean, e_mean,
                                                   self._temp_sum / n),
                    e_mean=e_mean, e2_mean=e2_mean, n_samples=n)


def kirkwood_buff_integral(r, g_r, r_upper=None):
    """G_ij(R) = 4 pi int_0^R (g_ij(r) - 1) r^2 dr by the trapezoid rule
    on the bin centres, R the last bin or r_upper.  The ideal gas gives 0
    at every R; a unit step at sigma gives -4/3 pi sigma^3."""
    r = np.asarray(r, np.float64)
    g = np.asarray(g_r, np.float64)
    if r_upper is not None:
        keep = r <= r_upper
        r, g = r[keep], g[keep]
    trapezoid = getattr(np, "trapezoid", None) or np.trapz
    return float(4.0 * np.pi * trapezoid((g - 1.0) * r * r, r))


def heat_of_vaporization(state, pressure_fd, masses=None):
    """Per-chain enthalpy of vaporization from a two-box Gibbs state,
    dH_vap = h_vap - h_liq with h = U / N + P V / N per box, P the
    ensemble's pressure_fd(state) (C, 2); K per molecule.  The liquid is
    the denser box.  The ideal gas gives 0 exactly."""
    if hasattr(state, "active0"):
        n = state.active0.sum(2) + state.active1.sum(2)
    else:
        n = state.active.sum(2)
    n = _host(n)
    v = _host(state.box) ** 3
    e = _host(state.energy)
    p = _host(pressure_fd)
    liq = (n / v).argmax(axis=1)
    ch = np.arange(n.shape[0])
    vap = 1 - liq
    n_l = np.maximum(n[ch, liq], 1.0)
    n_v = np.maximum(n[ch, vap], 1.0)
    du = e[ch, vap] / n_v - e[ch, liq] / n_l
    pv = p[ch, vap] * v[ch, vap] / n_v - p[ch, liq] * v[ch, liq] / n_l
    return du + pv
