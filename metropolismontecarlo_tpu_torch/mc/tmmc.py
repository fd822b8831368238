"""Transition-matrix Monte Carlo (TMMC): flat-histogram muVT and the
macrostate free-energy profile ln Pi(N) (counterpart of
metropolismontecarlo_tpu/mc/tmmc.py).

Every insertion/deletion attempt deposits its unbiased acceptance
probability into a collection matrix C(N, dN) (Fitzgerald, Picard &
Silver 1999; Errington, J. Chem. Phys. 118, 9915 (2003)).  The macrostate
transition probabilities P(N -> N') = C(N, dN) / sum C(N, .) give ln Pi
through detailed balance, ln Pi(N+1) - ln Pi(N) = ln P(N -> N+1) -
ln P(N+1 -> N), and a bias eta(N) = -ln Pi_est(N) on the acceptance (never
on the deposits) flattens the sampled N so walkers cross the vapour-liquid
barrier.  Reweighting in z and the equal-basin-weight condition give
coexistence (`coexistence`), the barrier a surface tension.

The samplers are the muVT step functions with their deposits on: `make_tmmc`
(monatomic, mc/gcmc.py) and make_gcmc_mol(tmmc=True) (rigid molecules,
driven by `TMMCMol`).  Both deposit both branches every attempt (Rao-
Blackwellized) with the exchange type's probability folded in; on the
kernel routes the sweep kernel's tmmc instantiation deposits in the launch.
The estimator is host numpy in float64, a copy of the JAX package's.
"""

import dataclasses

import numpy as np
import torch

from metropolismontecarlo_tpu_torch.mc.gcmc import _make_muvt


def make_tmmc(system, params, activity, capacity, dtype=torch.float64,
              mega=None, device="cuda", generator=None):
    """Build the biased monatomic muVT functions with collection-matrix
    accumulation: (init, run_steps, full_energy).

    init(box, n_init, n_chains) -> GCMCState (n_init a scalar or
    (n_chains,) stratified starts); run_steps(state, eta, n_steps) ->
    (state, cmat, uhist): eta the (cap + 1,) bias on the exchange
    acceptance, cmat this call's (C, cap + 1, 3) collection matrix [stay,
    up, down] and uhist the (C, cap + 1, 3) energy moments [count, sum E,
    sum E^2], both zeroed each call so the host pools in float64;
    full_energy(state) -> (C,).  mega=True / "full" as in mc/gcmc.py,
    both needing 0 < p_translate < 1; "full" deposits in the sweep
    kernel.  Sampling distribution: pi_biased(x) ~ pi_muVT(x)
    exp(eta(N(x))); the deposits record min(1, raw ratio) without eta."""
    return _make_muvt(system, params, activity, capacity, dtype, mega,
                      device, generator, tmmc=True)


def lnpi_from_cmat(cmat):
    """ln Pi(N) from a pooled collection matrix.

    cmat: (cap+1, 3) f64 — columns [stay, up, down] summed over chains
    and blocks.  Returns (lnpi, visited): lnpi (cap+1,) with
    lnpi[n_lo] = 0 on the largest contiguous visited range and -inf
    outside; visited (cap+1,) bool.  A macrostate counts as visited
    when it has attempt mass AND both links of the detailed-balance
    ratio into its neighbor are measured.
    """
    cmat = np.asarray(cmat, np.float64)
    cap1 = cmat.shape[0]
    rowsum = cmat.sum(axis=1)
    # P(N -> N+1) and P(N+1 -> N) both measured => the edge is usable
    with np.errstate(invalid="ignore", divide="ignore"):
        p_up = np.where(rowsum > 0, cmat[:, 1] / np.maximum(rowsum, 1e-300),
                        0.0)
        p_dn = np.where(rowsum > 0, cmat[:, 2] / np.maximum(rowsum, 1e-300),
                        0.0)
    edge = (p_up[:-1] > 0) & (p_dn[1:] > 0)
    if not edge.any():
        raise ValueError("collection matrix has no measured transitions — "
                         "run more steps before estimating ln Pi")
    # largest contiguous run of usable edges
    starts, lengths = [], []
    i = 0
    while i < edge.size:
        if edge[i]:
            j = i
            while j < edge.size and edge[j]:
                j += 1
            starts.append(i)
            lengths.append(j - i)
            i = j
        else:
            i += 1
    s = starts[int(np.argmax(lengths))]
    l = lengths[int(np.argmax(lengths))]
    lnpi = np.full(cap1, -np.inf)
    lnpi[s] = 0.0
    for n in range(s, s + l):
        lnpi[n + 1] = lnpi[n] + np.log(p_up[n]) - np.log(p_dn[n + 1])
    visited = np.isfinite(lnpi)
    return lnpi, visited


def bias_from_lnpi(lnpi):
    """eta = -ln Pi, extended flat beyond the visited range (clamped to
    the edge values) so unexplored macrostates are neither pushed away
    nor artificially favored."""
    lnpi = np.asarray(lnpi, np.float64)
    eta = -lnpi
    fin = np.isfinite(eta)
    if not fin.any():
        return np.zeros_like(eta)
    idx = np.where(fin)[0]
    eta[: idx[0]] = eta[idx[0]]
    eta[idx[-1] + 1:] = eta[idx[-1]]
    # gauge: eta(visited min) = 0 keeps the exp() arguments small
    return eta - eta[idx[0]]


def reweight_lnpi(lnpi, z0, z_new):
    """ln Pi at another activity: exact in z at fixed T, V."""
    n = np.arange(len(lnpi))
    out = np.asarray(lnpi, np.float64) + n * np.log(float(z_new) /
                                                    float(z0))
    fin = np.isfinite(out)
    return out - out[fin].max() if fin.any() else out


def _basin_stats(lnpi, n_sep=10, min_barrier=1.0):
    """Split a two-basin ln Pi at its interior minimum; return
    (ln W_vap, ln W_liq, N_vap, N_liq) — basin log-weights and
    basin-mean molecule numbers.

    A statistical ln Pi has many sub-kT noise wiggles, each technically
    a local max; accepting any of them lets the equal-weight solver
    latch onto a noise dimple near the global peak.  Guards:
      * a candidate second peak must be >= n_sep states from the global
        one and separated by an interior minimum >= min_barrier (kT)
        below BOTH peaks;
      * among qualifying candidates, pick the one with the DEEPEST
        separating valley (largest prominence of the lower peak), not
        the highest peak: the true vapor-liquid interfacial barrier is
        many kT while noise dimples are ~1 kT."""
    fin = np.where(np.isfinite(lnpi))[0]
    sub = lnpi[fin]
    imax1, imax2, isplit = _find_split(sub, n_sep, min_barrier)
    n_grid = fin.astype(np.float64)

    def side(sl):
        w = sub[sl]
        m = w.max()
        lw = m + np.log(np.exp(w - m).sum())
        nm = float((n_grid[sl] * np.exp(w - m)).sum() /
                   np.exp(w - m).sum())
        return lw, nm

    lw_a, n_a = side(slice(0, isplit + 1))
    lw_b, n_b = side(slice(isplit + 1, sub.size))
    if n_a <= n_b:
        return lw_a, lw_b, n_a, n_b
    return lw_b, lw_a, n_b, n_a


def _find_split(sub, n_sep, min_barrier):
    """Locate the two basin peaks and the dividing minimum on a finite
    ln Pi segment; raises ValueError when single-basin.  Returns
    (imax1, imax2, isplit) indices into `sub`."""
    imax1 = int(np.argmax(sub))
    best_sig, imax2 = -np.inf, None
    for i in range(sub.size):
        if abs(i - imax1) < n_sep or not _is_local_max(sub, i):
            continue
        lo, hi = sorted((imax1, i))
        barrier = float(np.min(sub[lo:hi + 1]))
        sig = min(float(sub[i]), float(sub[imax1])) - barrier
        if sig >= min_barrier and sig > best_sig:
            best_sig, imax2 = sig, i
    if imax2 is None:
        raise ValueError("ln Pi is single-basin at this activity")
    lo, hi = sorted((imax1, imax2))
    isplit = lo + int(np.argmin(sub[lo:hi + 1]))
    return imax1, imax2, isplit


def _is_local_max(a, i):
    l = a[i - 1] if i > 0 else -np.inf
    r = a[i + 1] if i + 1 < a.size else -np.inf
    return a[i] >= l and a[i] >= r


def coexistence(lnpi, z0, volume, z_lo=None, z_hi=None, tol=1e-10,
                n_sep=10, min_barrier=1.0):
    """Vapor-liquid coexistence from ln Pi by equal basin weights.

    Bisect on ln z until the reweighted ln Pi has equal integrated
    probability in the two basins (Errington 2003).  n_sep/min_barrier
    are the `_basin_stats` noise guards.  Returns a dict: z_coex,
    rho_vap, rho_liq (basin-mean N / V), dlnw (residual weight
    imbalance), and lnpi_coex.
    """
    lnpi = np.asarray(lnpi, np.float64)
    z_lo = z_lo if z_lo is not None else z0 * 1e-3
    z_hi = z_hi if z_hi is not None else z0 * 1e3

    fin_n = np.where(np.isfinite(lnpi))[0]
    n_mid = 0.5 * (fin_n[0] + fin_n[-1])

    def imbalance(z):
        lp = reweight_lnpi(lnpi, z0, z)
        try:
            lw_v, lw_l, _, _ = _basin_stats(lp, n_sep, min_barrier)
        except ValueError:
            # a strong tilt destroys one basin's local max entirely:
            # peak at low N => vapor-only (z far too low), at high N
            # => liquid-only (z far too high)
            peak = fin_n[np.argmax(lp[fin_n])]
            return -np.inf if peak < n_mid else np.inf
        return lw_l - lw_v          # grows with z

    f_lo, f_hi = imbalance(z_lo), imbalance(z_hi)
    if not (f_lo < 0 < f_hi):
        raise ValueError(
            f"coexistence not bracketed in [{z_lo}, {z_hi}]: "
            f"imbalance {f_lo:.3g} .. {f_hi:.3g}")
    a, b = np.log(z_lo), np.log(z_hi)
    for _ in range(200):
        m = 0.5 * (a + b)
        if imbalance(np.exp(m)) < 0:
            a = m
        else:
            b = m
        if b - a < tol:
            break
    z_c = float(np.exp(0.5 * (a + b)))
    lp = reweight_lnpi(lnpi, z0, z_c)
    lw_v, lw_l, n_v, n_l = _basin_stats(lp, n_sep, min_barrier)
    return {
        "z_coex": z_c,
        "rho_vap": n_v / volume,
        "rho_liq": n_l / volume,
        "dlnw": float(lw_l - lw_v),
        "lnpi_coex": lp,
    }


def surface_tension(lnpi_coex, box, temperature, n_sep=10,
                    min_barrier=1.0):
    """Vapor-liquid surface tension from the ln Pi interfacial barrier
    (Binder, Phys. Rev. A 25, 1699 (1982)).

    At coexistence the minimum between the basins corresponds to a
    liquid slab spanning the box with TWO planar interfaces of area
    L^2, so the barrier height is their free-energy cost:

        beta F_barrier = (ln Pi_vap_peak + ln Pi_liq_peak)/2 - ln Pi_min
        gamma = kT * beta F_barrier / (2 L^2)

    Single-box estimate (expect ~10-20% finite-size deviation from the
    thermodynamic limit at L ~ 6 sigma).  Returns gamma in
    [energy]/[length]^2 (reduced LJ: epsilon/sigma^2).
    """
    lnpi = np.asarray(lnpi_coex, np.float64)
    fin = np.where(np.isfinite(lnpi))[0]
    sub = lnpi[fin]
    imax1, imax2, isplit = _find_split(sub, n_sep, min_barrier)
    df = 0.5 * (float(sub[imax1]) + float(sub[imax2])) - float(sub[isplit])
    area = 2.0 * float(box) ** 2
    return float(temperature) * df / area


def u_moments(uhist):
    """Per-slice canonical energy moments: (<U>(N), var U(N)) from pooled
    [count, sum E, sum E^2] rows; NaN where unvisited."""
    uhist = np.asarray(uhist, np.float64)
    with np.errstate(invalid="ignore", divide="ignore"):
        cnt = uhist[:, 0]
        mean = np.where(cnt > 0, uhist[:, 1] / np.maximum(cnt, 1), np.nan)
        var = np.where(cnt > 1,
                       uhist[:, 2] / np.maximum(cnt, 1) - mean**2,
                       np.nan)
    return mean, np.maximum(var, 0.0)


def reweight_lnpi_temperature(lnpi, uhist, t_from, t_to,
                              second_order=True):
    """Extend ln Pi(N) to a nearby temperature from one run's per-slice
    energy moments, at fixed activity z:

      ln Pi(N; b') = ln Pi(N; b) - db <U>_N + db^2/2 var(U)_N + O(db^3)

    with db = b' - b.  Exact for the ideal gas; good for |dT|/T of a few
    percent.  var(U) needs f64 sampling (f32 E^2 accumulation loses the
    cancellation); pass second_order=False for f32-collected moments.
    Returns the extrapolated ln Pi, -inf where moments are missing.
    """
    lnpi = np.asarray(lnpi, np.float64)
    u_mean, u_var = u_moments(uhist)
    db = 1.0 / float(t_to) - 1.0 / float(t_from)
    out = lnpi - db * u_mean
    if second_order:
        # slices visited <= 1 time have no variance estimate — use 0
        # (first order) there rather than poisoning the state with NaN
        out = out + 0.5 * db * db * np.where(np.isfinite(u_var),
                                             u_var, 0.0)
    out = np.where(np.isfinite(lnpi) & np.isfinite(u_mean), out,
                   -np.inf)
    fin = np.isfinite(out)
    return out - out[fin].max() if fin.any() else out


class TMMC:
    """Blocks of biased monatomic sampling with collection-matrix pooling
    (host f64) and a bias refreshed from ln Pi after each block.

    >>> t = TMMC(lj_system(1), params, activity=0.03, capacity=192)
    >>> st = t.init(box=6.0, n_init=16, n_chains=256)      # on the card
    >>> for _ in range(12):
    ...     st, stats = t.run_block(st, 4000)
    >>> res = coexistence(t.lnpi(), t.activity, 6.0**3)
    """

    def __init__(self, system, params, activity, capacity,
                 dtype=torch.float64, mega=None, device="cuda",
                 generator=None):
        self.params = params
        self.activity = float(activity)
        self.capacity = int(capacity)
        self._init, self._run_steps, self.full_energy = make_tmmc(
            system, params, activity, capacity, dtype, mega, device,
            generator)
        self._reset_estimator()

    def _reset_estimator(self):
        self.cmat = np.zeros((self.capacity + 1, 3), np.float64)
        self.uhist = np.zeros((self.capacity + 1, 3), np.float64)
        self.eta = np.zeros(self.capacity + 1, np.float64)

    def init(self, box, n_init, n_chains):
        return self._init(box, n_init, n_chains)

    def _pool(self, state, n_steps, update_bias):
        """One block: run, pool this call's deposits in f64, and refresh
        the bias; returns (state, visited fraction)."""
        state, cmat, uhist = self._run_steps(state, self.eta, n_steps)
        self.cmat += cmat.detach().cpu().double().sum(0).numpy()
        self.uhist += uhist.detach().cpu().double().sum(0).numpy()
        if update_bias:
            try:
                self.eta = bias_from_lnpi(lnpi_from_cmat(self.cmat)[0])
            except ValueError:
                pass                      # not enough data yet
        return state, float(np.mean(self.cmat.sum(axis=1) > 0))

    def run_block(self, state, n_steps, drift_tol=None, update_bias=True):
        att0, acc0 = state.att, state.acc
        state, visited = self._pool(state, n_steps, update_bias)
        e = self.full_energy(state)
        # the drift scale of the monatomic app: the block's end alone
        stats = _block_stats(state, e, e, att0, acc0, self.capacity,
                             visited, ("acc_trans", "acc_insert",
                                       "acc_delete"))
        _check_drift(stats, drift_tol)
        return dataclasses.replace(state, energy=e), stats

    def reset_collection(self):
        """Burn-in discard: restart the accumulation (the bias is kept).
        Deposits from unequilibrated starts (stratified walkers still on
        their lattice) pollute C permanently and can fabricate ln Pi
        structure at the frontier; call after the equilibration blocks."""
        self.cmat[:] = 0.0
        self.uhist[:] = 0.0

    def lnpi(self):
        return lnpi_from_cmat(self.cmat)[0]

    def u_moments(self):
        """Per-slice (<U>(N), var U(N)) over the sampled within-slice
        distribution; NaN where unvisited."""
        return u_moments(self.uhist)


class TMMCMol(TMMC):
    """Flat-histogram muVT for rigid molecular species: the TMMC estimator
    on make_gcmc_mol(tmmc=True) (orientational insertions, carried Ewald
    S(k)); `coexistence` and `surface_tension` apply unchanged.

    >>> t = TMMCMol(spce_system(64), params, activity=1e-4)  # on the card
    >>> st = t.init(15.0, np.linspace(0, 60, 128).astype(int), 128)
    >>> for b in range(48):
    ...     st, stats = t.run_block(st, 2000)
    ...     if b == 11: t.reset_collection()      # burn-in discard
    >>> res = coexistence(t.lnpi(), t.activity, 15.0**3)
    """

    def __init__(self, system, params, activity, p_exchange=0.3,
                 dtype=torch.float64, chunk=8, n_orient=1,
                 bias="orientation", mega=None, device="cuda",
                 generator=None):
        from metropolismontecarlo_tpu_torch.mc.gcmc_mol import make_gcmc_mol

        self.params = params
        self.activity = float(activity)
        self.capacity = int(system.n_mol)
        self._init, self._run_steps, self.full_energy = make_gcmc_mol(
            system, params, activity, p_exchange, dtype, chunk, n_orient,
            bias, tmmc=True, mega=mega, device=device, generator=generator)
        self._reset_estimator()

    def run_block(self, state, n_steps, drift_tol=None, update_bias=True):
        att0, acc0 = state.att, state.acc
        e0 = state.energy
        state, visited = self._pool(state, n_steps, update_bias)
        e, sf = self.full_energy(state)
        stats = _block_stats(state, e, e0, att0, acc0, self.capacity,
                             visited, ("acc_trans", "acc_rot", "acc_insert",
                                       "acc_delete"))
        stats["sfac_err_max"] = float(torch.max((sf - state.sfac).abs()))
        _check_drift(stats, drift_tol)
        return dataclasses.replace(state, energy=e, sfac=sf), stats


def _block_stats(state, e, e0, att0, acc0, capacity, visited, acc_names):
    """The block statistics of a TMMC run: N range, visited fraction,
    acceptances and the drift of the carried energy against its
    recompute e, scaled by the larger of |e| and |e0| (TMMCMol passes the
    block's start: a biased walker can cross the whole N range in one
    block, and its f32 residue is small against the energies traversed
    but not against a near-zero endpoint)."""
    scale = torch.clamp_min(torch.maximum(e.abs(), e0.abs()), 1.0)
    drift = torch.max((e - state.energy).abs() / scale)
    n = state.active.sum(1)
    ratio = (state.acc - acc0) / torch.clamp_min(state.att - att0, 1)
    stats = {
        "n_mean": float(n.double().mean()),
        "n_min": int(n.min()),
        "n_max": int(n.max()),
        "visited_frac": visited,
        "full_frac": float((n >= capacity).double().mean()),
    }
    for i, name in enumerate(acc_names):
        stats[name] = float(ratio[:, i].mean())
    stats["drift_max_rel"] = float(drift)
    return stats


def _check_drift(stats, drift_tol):
    if drift_tol is not None and not stats["drift_max_rel"] < drift_tol:
        raise RuntimeError(f"energy drift over {drift_tol}: {stats}")
