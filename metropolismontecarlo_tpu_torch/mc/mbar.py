"""Multistate Bennett acceptance ratio (MBAR): optimal multistate
free-energy estimation and ensemble reweighting (the port's own copy of
metropolismontecarlo_tpu/mc/mbar.py, host numpy in float64).

BAR (mc/fep.bar_solve) is the minimum-variance estimator for one pair of
states.  MBAR (Shirts & Chodera, J. Chem. Phys. 129, 124105 (2008)) is its
K-state generalization: given samples from K thermodynamic states and the
reduced potential of every sample evaluated at every state, it solves the
coupled self-consistent equations

    f_k = -ln sum_n exp(-u_k(x_n)) / sum_j N_j exp(f_j - u_j(x_n))

for the reduced free energies f_k (defined up to a constant; f_0 = 0
here), and yields normalized weights that reweight the pooled samples
into any target state, including states never sampled.  For K = 2 the
stationary equations reduce exactly to Bennett's equation, so
`mbar_solve` and `fep.bar_solve` agree to solver tolerance.

The flagship application is temperature reweighting of replica-exchange
ladders (parallel/remc.py): a sample's reduced potential at ladder
temperature T_k is E_n / T_k, so the (K, N) matrix costs nothing beyond
the energies a run already logs (`reweight_temperature`); muVT runs pool
over activities (`reweight_activity_mbar`) and jointly over (T, z)
(`reweight_muvt`).
"""

import numpy as np


def _logsumexp(a, axis=None, b=None):
    """log sum_i b_i exp(a_i), stable, with -inf entries contributing
    zero (b_i > 0 required where used)."""
    a = np.asarray(a, np.float64)
    m = np.max(a, axis=axis, keepdims=True)
    m = np.where(np.isfinite(m), m, 0.0)
    t = np.exp(a - m)
    if b is not None:
        b = np.asarray(b, np.float64)
        if axis is not None and b.ndim < a.ndim:
            shape = [1] * a.ndim
            shape[axis] = -1
            b = b.reshape(shape)
        t = b * t
    s = np.sum(t, axis=axis, keepdims=True)
    out = m + np.log(s)
    return np.squeeze(out, axis=axis) if axis is not None else out.item()


def mbar_solve(u_kn, n_k, tol=1e-12, max_iter=100000):
    """Solve the MBAR self-consistent equations.

    u_kn: (K, N) reduced potentials — row k is u_k evaluated on ALL N
    pooled samples (N = sum of per-state sample counts; sample order is
    arbitrary but must match across rows).  +inf entries (hard-core
    vetoed configurations) are legal and carry zero weight.  n_k: (K,)
    number of samples drawn FROM each state.  States with n_k == 0 are
    allowed (pure prediction states) — they receive free energies but
    contribute nothing to the mixture denominator.

    Returns f_k (K,) with f[0] = 0: f_k - f_j estimates
    -ln(Z_k / Z_j) in reduced units.

    Self-consistent iteration on the pooled-mixture form:
        d_n   = ln sum_j n_j exp(f_j - u_jn)      (log mixture density)
        f_k'  = -ln sum_n exp(-u_kn - d_n)
    The map is a contraction toward the unique solution (Shirts &
    Chodera §III); convergence is declared on max|f' - f| < tol.
    """
    u_kn = np.asarray(u_kn, np.float64)
    n_k = np.asarray(n_k, np.float64).ravel()
    K, N = u_kn.shape
    assert n_k.shape == (K,) and np.sum(n_k) > 0
    assert not np.any(np.isnan(u_kn)), "NaN reduced potentials"
    sampled = n_k > 0
    log_n = np.where(sampled, np.log(np.maximum(n_k, 1.0)), -np.inf)

    f = np.zeros(K)
    # free initialization: one Zwanzig (exponential-averaging) sweep
    # from state 0 gives the right order of magnitude instantly.  A
    # sample with u_0 = +inf makes the exponent inf - inf = NaN — drop
    # such samples from the init (it only needs the magnitude right).
    expo = u_kn[0:1] - u_kn
    expo = np.where(np.isfinite(expo), expo, -np.inf)
    f = -_logsumexp(expo, axis=1) + np.log(N)
    f = np.where(np.isfinite(f), f - f[0], 0.0)
    for _ in range(max_iter):
        d_n = _logsumexp((log_n + f)[sampled, None] - u_kn[sampled],
                         axis=0)                          # (N,)
        f_new = -_logsumexp(-u_kn - d_n[None, :], axis=1)  # (K,)
        f_new -= f_new[0]
        delta = np.max(np.abs(f_new - f))
        if np.isnan(delta):
            raise RuntimeError("MBAR iteration produced NaN free energies")
        f = f_new
        if delta < tol:
            break
    else:
        raise RuntimeError(f"MBAR did not converge: last delta {delta:.3e}")
    return f


def mbar_weights(u_n, f_k, u_kn, n_k):
    """Normalized MBAR weights of the pooled samples in a TARGET state.

    u_n: (N,) reduced potential of every pooled sample at the target
    state (which need not be one of the K sampled states).  f_k, u_kn,
    n_k: a converged `mbar_solve` solution and its inputs.

    Returns (f_target, w_n, ess): the target's reduced free energy on
    the same f[0] = 0 scale, weights summing to 1 (zero where u_n is
    +inf), and the Kish effective sample size 1 / sum w^2 — the
    reliability diagnostic (ess ~ N means the target overlaps the
    mixture; ess ~ 1 means extrapolation, don't trust the estimate).
    """
    u_n = np.asarray(u_n, np.float64).ravel()
    u_kn = np.asarray(u_kn, np.float64)
    n_k = np.asarray(n_k, np.float64).ravel()
    sampled = n_k > 0
    log_n = np.log(n_k[sampled])
    d_n = _logsumexp((log_n + np.asarray(f_k)[sampled])[:, None]
                     - u_kn[sampled], axis=0)
    log_w = -u_n - d_n
    f_target = -_logsumexp(log_w)
    log_w = log_w + f_target                    # normalized in log space
    w = np.where(np.isfinite(log_w), np.exp(log_w), 0.0)
    ess = 1.0 / np.sum(w * w)
    return f_target, w, ess


def reweight_temperature(energies, temps, t_targets, pv=None):
    """Temperature reweighting of a replica ladder via MBAR.

    energies: (K, S) per-ladder-state energy samples (framework units,
    e.g. Kelvin or LJ-reduced) — S samples from each of the K ladder
    temperatures `temps` (K,).  For NPT ladders pass pv = P * V samples
    of the same shape; the reduced potential becomes (E + PV) / T and
    the returned `e_mean`/`c` are enthalpy-based.  t_targets: (M,)
    temperatures to predict at (inside or between ladder rungs;
    extrapolation is flagged by a collapsing ess).

    Returns a dict of (M,) arrays:
      f       reduced free energies of the targets (f(T_0_ladder) = 0
              gauge) — beta*A differences up to sample-count constants,
      e_mean  <E>(T)  (or <E + PV> for NPT),
      e_var   Var(E)(T),
      c       fluctuation heat capacity Var(E)/T^2 (configurational
              C_v, or C_p-like for NPT), same units as E per T,
      ess     effective sample size at each target.

    Exactness anchors (tests/test_torch_fep_mbar.py): for the harmonic model
    E = x^2/2, <E>(T) = T/2 and C = 1/2 at EVERY T; reweighting at a
    ladder temperature reproduces that rung's direct sample mean.
    """
    e = np.asarray(energies, np.float64)
    if pv is not None:
        e = e + np.asarray(pv, np.float64)
    temps = np.asarray(temps, np.float64).ravel()
    K, S = e.shape
    assert temps.shape == (K,)
    pooled = e.ravel()                           # (N,) N = K*S
    u_kn = pooled[None, :] / temps[:, None]
    n_k = np.full(K, S, np.float64)
    f_k = mbar_solve(u_kn, n_k)

    out = {k: [] for k in ("f", "e_mean", "e_var", "c", "ess")}
    for t in np.atleast_1d(np.asarray(t_targets, np.float64)):
        f_t, w, ess = mbar_weights(pooled / t, f_k, u_kn, n_k)
        e_mean = float(np.sum(w * pooled))
        e_var = float(np.sum(w * (pooled - e_mean) ** 2))
        out["f"].append(f_t)
        out["e_mean"].append(e_mean)
        out["e_var"].append(e_var)
        out["c"].append(e_var / t**2)
        out["ess"].append(ess)
    return {k: np.asarray(v) for k, v in out.items()}


def reweight_muvt(energies, n_kn, temps, activities, targets):
    """Joint (T, z) reweighting of muVT runs via MBAR.

    The full grand-canonical reduced potential of a sample is
    u_k(x) = U(x) / T_k - N(x) ln z_k, so pooling runs that differ in
    temperature AND activity needs the joint (E, N) time series —
    `reweight_temperature` (fixed z) and `reweight_activity_mbar`
    (fixed T, where the U term cancels) are the two marginals of this
    estimator.  One (T, z) grid of short runs then predicts <N>, <E>,
    and their fluctuations at ANY (T, z) with honest ESS diagnostics.

    energies, n_kn: (K, S) per-state energy and molecule-number samples
    (same sample order).  temps, activities: (K,) state parameters.
    targets: sequence of (T, z) pairs.

    Returns a dict of arrays over targets: f, n_mean, n_var, e_mean,
    e_var, ess.

    Exactness anchor (tests/test_torch_fep_mbar.py): the exponential-
    molecule toy model (each molecule carries an independent Exp(1/T) energy, unit
    single-particle DOS) has N ~ Poisson(z V T) and <E> = <N> T in
    closed form at EVERY (T, z) — errors in either the U/T or the
    N ln z term of the reduced potential break it.
    """
    e = np.asarray(energies, np.float64)
    n = np.asarray(n_kn, np.float64)
    temps = np.asarray(temps, np.float64).ravel()
    zs = np.asarray(activities, np.float64).ravel()
    K, S = e.shape
    assert n.shape == (K, S) and temps.shape == zs.shape == (K,)
    assert np.all(zs > 0.0) and np.all(temps > 0.0)
    pe, pn = e.ravel(), n.ravel()
    u_kn = pe[None, :] / temps[:, None] - pn[None, :] * np.log(zs)[:, None]
    nsamp = np.full(K, S, np.float64)
    f_k = mbar_solve(u_kn, nsamp)

    out = {k: [] for k in ("f", "n_mean", "n_var", "e_mean", "e_var",
                           "ess")}
    for t_t, z_t in targets:
        if t_t <= 0.0 or z_t <= 0.0:
            raise ValueError("target temperature and activity must be "
                             "positive")
        u_t = pe / t_t - pn * np.log(z_t)
        f_t, w, ess = mbar_weights(u_t, f_k, u_kn, nsamp)
        n_mean = float(np.sum(w * pn))
        e_mean = float(np.sum(w * pe))
        out["f"].append(f_t)
        out["n_mean"].append(n_mean)
        out["n_var"].append(float(np.sum(w * (pn - n_mean) ** 2)))
        out["e_mean"].append(e_mean)
        out["e_var"].append(float(np.sum(w * (pe - e_mean) ** 2)))
        out["ess"].append(ess)
    return {k: np.asarray(v) for k, v in out.items()}


def reweight_activity_mbar(n_kn, activities, z_targets):
    """Pool muVT (GCMC) runs at several activities via MBAR.

    `gcmc.reweight_activity` reweights ONE run's N-histogram — exact,
    but its reach is set by that single run's sampled N range.  Pooling
    runs at different activities z_k extends the reach to the union of
    their N ranges with optimal (MBAR) weighting in the overlap.  The
    key simplification at fixed T, V: the muVT reduced potential is
    u_k(x) = beta U(x) - N(x) ln z_k, and the beta*U term is COMMON to
    every activity state, so it cancels out of the MBAR equations
    identically (a per-sample shift shared by all states leaves the
    self-consistent f_k and all weights invariant).  Only the molecule
    counts are needed:  u_kn = -N_n ln z_k.

    n_kn: (K, S) molecule-number samples — row k from the run at
    activity `activities[k]` (e.g. stacked `state.active.sum(-1)`
    snapshots, flattened over chains x blocks).  z_targets: activities
    to predict at.

    Returns a dict of arrays over targets: n_mean, n_var, ess, and
    pn — (M, N_max+1) normalized P(N) at each target.

    Exactness anchors (tests/test_torch_fep_mbar.py): ideal gas gives
    N ~ Poisson(z V) at EVERY activity; a K = 1 pool must equal
    `gcmc.reweight_activity` on the same run's histogram to solver
    tolerance (the two estimators coincide identically at K = 1).
    """
    n_kn = np.asarray(n_kn, np.float64)
    zs = np.asarray(activities, np.float64).ravel()
    K, S = n_kn.shape
    assert zs.shape == (K,) and np.all(zs > 0.0)
    pooled = n_kn.ravel()                        # (N,) molecule counts
    u_kn = -pooled[None, :] * np.log(zs)[:, None]
    nsamp = np.full(K, S, np.float64)
    f_k = mbar_solve(u_kn, nsamp)

    n_max = int(pooled.max())
    out = {k: [] for k in ("n_mean", "n_var", "ess", "pn")}
    for z in np.atleast_1d(np.asarray(z_targets, np.float64)):
        if z <= 0.0:
            raise ValueError("activities must be positive")
        _, w, ess = mbar_weights(-pooled * np.log(z), f_k, u_kn, nsamp)
        n_mean = float(np.sum(w * pooled))
        out["n_mean"].append(n_mean)
        out["n_var"].append(float(np.sum(w * (pooled - n_mean) ** 2)))
        out["ess"].append(ess)
        out["pn"].append(np.bincount(pooled.astype(np.int64), weights=w,
                                     minlength=n_max + 1))
    return {k: np.asarray(v) for k, v in out.items()}
