"""Grand-canonical (muVT) MC for the monatomic LJ fluid (counterpart of
metropolismontecarlo_tpu/mc/gcmc.py).

Moves: displacement, insertion at a uniform position into the first free
slot, deletion of a uniform active slot, with the textbook acceptance
(Frenkel & Smit ch. 5; Lambda = 1, so beta mu = ln z):

    insert:  min[1, z V / (N + 1) exp(-beta dU)]
    delete:  min[1, N / (z V)     exp(-beta dU)]

A fixed capacity of slots per chain with an activity mask, every chain an
independent muVT sample.  Cut (optionally linearly shifted) LJ only;
`use_lrc` (unshifted LJ) adds the tail U_lrc = g(V) N^2, whose exchange
deltas g ((N + dn)^2 - N^2) are affine in N and ride the sweep kernel's
quadratic constant lane (wc) on the kernel routes.  Single species, P = 1
(models/monatomic.lj_system).

Three routes, chosen by `mega` (as in mc/gcmc_mol.py):
  None    one attempt of every chain per step in plain tensor code;
  True    cycles of one activity-masked sweep-kernel sweep over a
          capacity-sized copy of the system (identity quaternions, a
          one-row dummy S(k)) plus x_per exchange-only plain steps;
  "full"  cycles of one sweep-kernel launch that runs the cap moves and
          the x_per exchange attempts.
The transition-matrix sampler of mc/tmmc.py is the same construction with
its deposits switched on (`_make_muvt(..., tmmc=True)`).
"""

import dataclasses
import math

import numpy as np
import torch

from metropolismontecarlo_tpu_torch.io.configs import cubic_lattice
from metropolismontecarlo_tpu_torch.ops import tail as tail_ops
from metropolismontecarlo_tpu_torch.ops.lj import _shift_coeffs
from metropolismontecarlo_tpu_torch.ops.pbc import min_image
from metropolismontecarlo_tpu_torch.utils.activity import (
    clear_slot,
    set_slot,
    zero_empty,
)
from metropolismontecarlo_tpu_torch.utils.shard import chain_rows, rand_chains


@dataclasses.dataclass
class GCMCState:
    """Per-chain monatomic muVT state; every tensor leads with the chains
    axis C.  The JAX state's `key` has no counterpart: draws come from the
    torch.Generator that make_gcmc / make_tmmc hold."""

    com: torch.Tensor      # (C, cap, 3) slot positions (junk where inactive)
    active: torch.Tensor   # (C, cap) bool
    box: torch.Tensor      # (C,)
    energy: torch.Tensor   # (C,) carried total potential energy
    acc: torch.Tensor      # (C, 3) int32 accepted [trans, insert, delete]
    att: torch.Tensor      # (C, 3) int32 attempted


def _lj_coeffs(system, params):
    """(eps, sigma^2, lam1, lam2) of the single LJ type, python floats;
    the linear shift is eps (lam1 + lam2 r)."""
    if system.atoms_per_mol != 1 or len(system.species_slices) != 1:
        raise ValueError("GCMC app supports single-species monatomic "
                         "systems (models/monatomic.lj_system)")
    eps = float(np.asarray(system.eps_table)[0, 0])
    sig = float(np.asarray(system.sig_table)[0, 0])
    lam1 = lam2 = 0.0
    if params.lj_shift == "linear":
        l1, l2 = _shift_coeffs(np.asarray([params.r_cut / sig]))
        lam1, lam2 = float(l1[0]), float(l2[0]) / sig
    return eps, sig ** 2, lam1, lam2


def make_slot_lj(system, params, capacity, dtype, device="cuda"):
    """Masked-slot LJ energies shared by the monatomic muVT apps, batched
    over chains.  Returns (site_energy, full_energy_one, nth_active,
    lrc_g):
      site_energy(com (C, cap, 3), active (C, cap), box (C,), pos (C, 3),
          exclude (C,) or an int) -> (C,) energy of one site against every
          active slot other than exclude;
      full_energy_one(com, active, box) -> (C,) total active-pair energy
          (+ g(box) N^2 with the tail on);
      nth_active(mask (C, cap), n_idx (C,)) -> (C,) slot of the
          (n_idx + 1)-th True;
      lrc_g: None with the tail off, else box -> g with U_lrc = g N^2."""
    eps, sig2, lam1, lam2 = _lj_coeffs(system, params)
    rc2 = params.r_cut ** 2
    cap = int(capacity)
    shifted = params.lj_shift == "linear"
    slots = torch.arange(cap, device=device)

    lrc_g = None
    if params.use_lrc and not shifted:
        c_mm = tail_ops.mol_tail_coeff(
            [1.0], [1.0], np.asarray(system.eps_table)[:1, :1],
            np.asarray(system.sig_table)[:1, :1], params.r_cut)

        def lrc_g(box):     # noqa: F811
            return tail_ops.LRC_PREFACTOR * c_mm / box ** 3

    def _pair_pot(d2, mask):
        d2s = torch.where(mask, torch.clamp_min(d2, 1e-4),
                          torch.ones((), dtype=d2.dtype, device=d2.device))
        s2 = sig2 / d2s
        s6 = s2 * s2 * s2
        pot = 4.0 * eps * (s6 * s6 - s6)
        if shifted:
            pot = pot + eps * (lam1 + lam2 * torch.sqrt(d2s))
        return torch.where(mask, pot, 0.0)

    def site_energy(com, active, box, pos, exclude):
        dr = min_image(pos[:, None, :] - com, box[:, None, None])
        d2 = torch.sum(dr * dr, dim=-1)                          # (C, cap)
        excl = torch.as_tensor(exclude, device=com.device).reshape(-1, 1)
        mask = active & (d2 < rc2) & (slots[None, :] != excl)
        return torch.sum(_pair_pot(d2, mask), dim=-1)

    upper = torch.triu(torch.ones((cap, cap), dtype=torch.bool,
                                  device=device), diagonal=1)

    def full_energy_one(com, active, box):
        dr = min_image(com[:, :, None, :] - com[:, None, :, :],
                       box[:, None, None, None])
        d2 = torch.sum(dr * dr, dim=-1)                     # (C, cap, cap)
        pair = active[:, :, None] & active[:, None, :] & (d2 < rc2) & upper
        e = torch.sum(_pair_pot(d2, pair), dim=(1, 2))
        if lrc_g is not None:
            nf = active.sum(1).to(e.dtype)
            e = e + lrc_g(box) * nf * nf
        return e

    def nth_active(mask, n_idx):
        c = torch.cumsum(mask.to(torch.int64), dim=1)
        return (c >= n_idx[:, None] + 1).to(torch.int64).argmax(dim=1)

    return site_energy, full_energy_one, nth_active, lrc_g


def capacity_system(system, cap):
    """A cap-molecule copy of a single-species system (the template
    molecule in every slot): the System the activity-masked kernel sweeps
    when the app's capacity differs from the model's n_mol."""
    def rep(a):
        a = np.asarray(a)
        return np.broadcast_to(a[:1], (cap,) + a.shape[1:]).copy()

    return dataclasses.replace(
        system, n_mol=cap, body=rep(system.body), masses=rep(system.masses),
        charges=rep(system.charges), type_ids=rep(system.type_ids),
        species=None)


def check_device(device, generator):
    """The device as a torch.device, the generator (seeded 0 when None);
    raises for a CUDA device without a GPU and for a generator elsewhere."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: the muVT apps run on the GPU by default; pass "
            "device='cpu' to run the kernels' plain versions on the CPU")
    if generator is None:
        generator = torch.Generator(device=device)
        generator.manual_seed(0)
    if generator.device.type != device.type:
        raise ValueError(f"generator on {generator.device}, state on "
                         f"{device}")
    return device, generator


def _make_muvt(system, params, activity, capacity, dtype, mega, device,
               generator, tmmc):
    """make_gcmc (tmmc=False) and mc/tmmc.make_tmmc (tmmc=True): one step
    function for both, so that the two draw the same numbers in the same
    order and a zero bias reproduces the muVT trajectory bit for bit."""
    device, generator = check_device(device, generator)
    beta = 1.0 / params.temperature
    z_arr = torch.as_tensor(np.asarray(activity), dtype=dtype, device=device)
    if z_arr.dim() not in (0, 1):
        raise ValueError("activity must be a scalar or a (n_chains,) "
                         "ladder")
    p_t = float(params.p_translate)
    cap = int(capacity)
    site_energy, full_one, nth_active, lrc_g = make_slot_lj(
        system, params, cap, dtype, device)
    move_on = p_t > 0.0

    def rand(*shape):
        return rand_chains(shape, generator, dtype, device)

    def _one_step(st, z, eta=None, cmat=None, uhist=None):
        """One attempt of every chain; with tmmc, deposits into cmat and
        uhist (C, cap + 1, 3) in place."""
        com, active, box, e = st.com, st.active, st.box, st.energy
        C = com.shape[0]
        ar = torch.arange(C, device=device)
        us = rand(C, 3)          # [move type, slot pick, accept]
        # one draw serves the displacement and the insertion position (the
        # two are exclusive move types), as the JAX step's k_pos does
        u_pos = rand(C, 3)
        n = active.sum(1)
        nf = n.to(dtype)
        # move type: 0 displace, 1 insert, 2 delete
        mt = torch.where(us[:, 0] < p_t, 0,
                         torch.where(us[:, 0] < p_t + 0.5 * (1.0 - p_t), 1,
                                     2))
        idx = nth_active(active, torch.floor(us[:, 1] * nf).to(torch.int64))
        pos_old = com[ar, idx]
        u_old = site_energy(com, active, box, pos_old, idx)
        if move_on:
            new_pos = torch.remainder(pos_old + (u_pos - 0.5) * params.dr_max,
                                      box[:, None])
            u_new = site_energy(com, active, box, new_pos, idx)
        pos_i = u_pos * box[:, None]
        u_ins = site_energy(com, active, box, pos_i, -1)
        slot = (~active).to(torch.int64).argmax(dim=1)
        full = n >= cap

        vol = box ** 3
        if lrc_g is not None:
            g = lrc_g(box)
            dl_i, dl_d = g * (2.0 * nf + 1.0), g * (-2.0 * nf + 1.0)
        else:
            dl_i = dl_d = torch.zeros_like(e)
        r_i = z * vol / (nf + 1.0) * torch.exp(-beta * (u_ins + dl_i))
        r_d = nf / (z * vol) * torch.exp(beta * u_old - beta * dl_d)
        u = us[:, 2]
        if move_on:
            ok_t = (mt == 0) & (n > 0) & (u < torch.exp(-beta * (u_new
                                                                 - u_old)))
        else:
            ok_t = torch.zeros_like(full)
        if tmmc:
            # Rao-Blackwellized deposit of both unbiased acceptances, the
            # exchange type's probability folded in; uhist takes the
            # pre-step energy, in the pre-step row
            pa_i = torch.where(full, 0.0, torch.clamp_max(r_i, 1.0))
            pa_d = torch.where(n > 0, torch.clamp_max(r_d, 1.0), 0.0)
            p_x = 0.5 * (1.0 - p_t)
            up_v, dn_v = p_x * pa_i, p_x * pa_d
            cmat[ar, n] += torch.stack([1.0 - up_v - dn_v, up_v, dn_v], 1)
            uhist[ar, n] += torch.stack([torch.ones_like(e), e, e * e], 1)
            # the bias multiplies the raw ratios (the clamped reads are
            # behind the full / n == 0 refusals)
            eta_n = eta[n]
            r_i = r_i * torch.exp(eta[torch.clamp_max(n + 1, cap)] - eta_n)
            r_d = r_d * torch.exp(eta[torch.clamp_min(n - 1, 0)] - eta_n)
        ok_i = (mt == 1) & ~full & (u < r_i)
        ok_d = (mt == 2) & (n > 0) & (u < r_d)

        com = com.clone()
        zero = torch.zeros_like(e)
        if move_on:
            com[ar, idx] = torch.where(ok_t[:, None], new_pos, pos_old)
            e = e + torch.where(ok_t, u_new - u_old, zero)
        com[ar, slot] = torch.where(ok_i[:, None], pos_i, com[ar, slot])
        active = clear_slot(set_slot(active, slot, ok_i), idx, ok_d)
        e = e + torch.where(ok_i, u_ins + dl_i, zero) \
            + torch.where(ok_d, -u_old + dl_d, zero)
        a_row = torch.stack([ok_t, ok_i, ok_d], 1).to(torch.int32)
        t_row = (torch.arange(3, device=device)[None, :]
                 == mt[:, None]).to(torch.int32)
        return dataclasses.replace(st, com=com, active=active, energy=e,
                                   acc=st.acc + a_row, att=st.att + t_row)

    def full_energy(state):
        return full_one(state.com, state.active, state.box)

    def _z_of(state):
        """(C,) per-chain activity: the scalar broadcast, or the ladder's
        rows of these chains (utils/shard.py chain_rows)."""
        return chain_rows(z_arr, state.com.shape[0], "activity ladder")

    def _tm_zeros(state):
        return torch.zeros((state.com.shape[0], cap + 1, 3), dtype=dtype,
                           device=device)

    def _eta(eta):
        return torch.as_tensor(eta).to(device=device, dtype=dtype)

    if tmmc:
        def run_steps(state, eta, n_steps):
            z, eta = _z_of(state), _eta(eta)
            cmat, uhist = _tm_zeros(state), _tm_zeros(state)
            for _ in range(int(n_steps)):
                state = _one_step(state, z, eta, cmat, uhist)
            return state, cmat, uhist
    else:
        def run_steps(state, n_steps):
            z = _z_of(state)
            for _ in range(int(n_steps)):
                state = _one_step(state, z)
            return state

    if mega:
        if dtype != torch.float32:
            raise ValueError("mega GCMC requires dtype=float32 (the "
                             "whole-sweep kernel is f32)")
        if mega not in (True, "full"):
            raise ValueError(f"mega must be True or 'full': {mega!r}")
        if p_t >= 1.0 or (p_t <= 0.0 and (tmmc or mega == "full")):
            raise ValueError("mega GCMC needs 0 < p_translate < 1 "
                             "(p_translate < 1 for a mega=True muVT build)")
        # import here: mc.moves imports nothing of this module
        from metropolismontecarlo_tpu_torch.mc.moves import make_mega_sweep_fn

        cap_sys = capacity_system(system, cap)
        A_pad = cap_sys.n_atoms_padded
        f32 = torch.float32
        x_per = max(1, int(round(cap * (1.0 - p_t) / p_t))) \
            if p_t > 0.0 else 0

        def n_cycles(n_steps):
            return max(1, int(round(n_steps / (cap + x_per))))

        def planes(state):
            """The kernel's molecular layout of the slots: identity
            quaternions, the positions as the atom planes, a dummy S(k)
            row."""
            C = state.com.shape[0]
            quat = torch.zeros((C, cap, 4), dtype=f32, device=device)
            quat[..., 0] = 1.0
            coords = torch.nn.functional.pad(
                state.com.to(f32).transpose(1, 2), (0, A_pad - cap))
            return (state.com.to(f32), quat, coords.contiguous(),
                    state.active, state.box.to(f32),
                    torch.zeros((C, 1, 2), dtype=f32, device=device))

        if mega == "full":
            sweep_x = make_mega_sweep_fn(cap_sys, params, None, None, device,
                                         with_activity=True, n_exch=x_per,
                                         tmmc_exch=tmmc)

            def cycle(state, eta=None):
                """One launch; with tmmc also its (cmat, uhist)."""
                C = state.com.shape[0]
                zeros = torch.zeros((C,), dtype=f32, device=device)
                # the tail rides the quadratic-in-N constant lane (wc)
                wc = lrc_g(state.box.to(f32)) if lrc_g is not None else zeros
                out = sweep_x(*planes(state), generator,
                              _z_of(state).to(f32), zeros,
                              wc, energy=state.energy, eta=eta)
                com, _, _, active, _, d_e, acc4, att4 = out[:8]
                sel = [0, 2, 3]      # [trans, rot, ins, del] -> (C, 3)
                st = dataclasses.replace(
                    state, com=com, active=active,
                    energy=zero_empty(state.energy + d_e, None, active)[0],
                    acc=state.acc + acc4[:, sel].to(torch.int32),
                    att=state.att + att4[:, sel].to(torch.int32))
                return (st,) + tuple(out[8:10]) if tmmc else st

            if tmmc:
                def run_steps(state, eta, n_steps):   # noqa: F811
                    eta = _eta(eta)
                    cmat, uhist = _tm_zeros(state), _tm_zeros(state)
                    for _ in range(n_cycles(n_steps)):
                        state, cm, uh = cycle(state, eta)
                        cmat, uhist = cmat + cm, uhist + uh
                    return state, cmat, uhist
            else:
                def run_steps(state, n_steps):        # noqa: F811
                    for _ in range(n_cycles(n_steps)):
                        state = cycle(state)
                    return state
        else:
            sweep_act = make_mega_sweep_fn(cap_sys, params, None, None,
                                           device, with_activity=True)
            run_x = None
            if x_per:
                # the exchange-only plain sampler (p_translate = 0) on the
                # same generator, x_per steps of it per kernel sweep
                _, run_x, _ = _make_muvt(
                    system, dataclasses.replace(params, p_translate=0.0),
                    activity, cap, dtype, None, device, generator, tmmc)

            def sweep_state(state):
                com, _, _, _, d_e, acc2, att2 = sweep_act(*planes(state),
                                                          generator)
                pad = torch.nn.functional.pad
                return dataclasses.replace(
                    state, com=com, energy=state.energy + d_e,
                    acc=state.acc + pad(acc2[:, :1].to(torch.int32), (0, 2)),
                    att=state.att + pad(att2[:, :1].to(torch.int32), (0, 2)))

            if tmmc:
                def run_steps(state, eta, n_steps):   # noqa: F811
                    cmat, uhist = _tm_zeros(state), _tm_zeros(state)
                    for _ in range(n_cycles(n_steps)):
                        state = sweep_state(state)
                        state, cm, uh = run_x(state, eta, x_per)
                        cmat, uhist = cmat + cm, uhist + uh
                    return state, cmat, uhist
            else:
                def run_steps(state, n_steps):        # noqa: F811
                    for _ in range(n_cycles(n_steps)):
                        state = sweep_state(state)
                        if run_x is not None:
                            state = run_x(state, x_per)
                    return state

    def init(box, n_init, n_chains):
        """Lattice slots, the first n_init of each chain active; n_init a
        scalar (with tmmc also (n_chains,) per-chain starts)."""
        n0 = np.asarray(n_init, np.int64)
        if n0.ndim and not tmmc:
            raise ValueError("n_init must be a scalar")
        if np.any(n0 > cap):
            raise ValueError("n_init exceeds capacity")
        if n0.ndim == 1:
            n0 = chain_rows(n0, n_chains, "per-chain n_init")
        if z_arr.dim() == 1:
            chain_rows(z_arr, n_chains, "activity ladder")
        # a lattice, not uniform random positions: random placement seeds
        # overlapping pairs whose huge floored energies cancel imperfectly
        # against the carried total
        lat = torch.tensor(cubic_lattice(cap, float(box)), dtype=dtype,
                           device=device)
        com = lat[None].expand(n_chains, cap, 3).contiguous()
        active = torch.arange(cap, device=device)[None, :] \
            < torch.as_tensor(n0, device=device).reshape(-1, 1)
        state = GCMCState(
            com=com, active=active.expand(n_chains, cap).contiguous(),
            box=torch.full((n_chains,), float(box), dtype=dtype,
                           device=device),
            energy=torch.zeros((n_chains,), dtype=dtype, device=device),
            acc=torch.zeros((n_chains, 3), dtype=torch.int32, device=device),
            att=torch.zeros((n_chains, 3), dtype=torch.int32, device=device))
        return dataclasses.replace(state, energy=full_energy(state))

    return init, run_steps, full_energy


def make_gcmc(system, params, activity, capacity, dtype=torch.float64,
              mega=None, device="cuda", generator=None):
    """Build the monatomic muVT functions: (init, run_steps, full_energy).

    activity: a scalar, or a (n_chains,) activity ladder (each chain
    samples its own muVT state).  init(box, n_init, n_chains) ->
    GCMCState (lattice slots, the first n_init active); run_steps(state,
    n_steps) -> state (one displacement-or-exchange attempt of every chain
    per step, or cycles of cap kernel moves + x_per attempts with mega);
    full_energy(state) -> (C,) dense masked recompute (the drift anchor).
    mega=True / "full": the kernel routes (module docstring); they need
    dtype=float32.  device: the card unless the caller passes "cpu";
    generator: the torch.Generator (on device) behind every draw, seeded 0
    when None."""
    return _make_muvt(system, params, activity, capacity, dtype, mega,
                      device, generator, tmmc=False)


def n_counts(state, capacity):
    """Pooled N-histogram over chains: (capacity + 1,) counts of the
    chains' current molecule numbers (monatomic and molecular states)."""
    n = state.active.sum(-1).detach().cpu().numpy().astype(np.int64).ravel()
    return np.bincount(n, minlength=int(capacity) + 1)


def reweight_activity(hist, z0, z_new):
    """Exact muVT histogram reweighting in the activity:
    P_z'(N) ~ P_z0(N) (z'/z0)^N at fixed T, V.  Returns n_mean, n_var and
    ess, the effective-sample fraction (sum w)^2 / (sum w^2 * total)."""
    hist = np.asarray(hist, np.float64)
    if hist.sum() <= 0.0:
        raise ValueError("empty N-histogram — accumulate n_counts over "
                         "at least one block before reweighting")
    if z0 <= 0.0 or z_new <= 0.0:
        raise ValueError("activities must be positive")
    n = np.arange(len(hist))
    logw = n * np.log(z_new / z0)
    logw -= logw[hist > 0].max()
    # mask empty bins before exponentiating: a far-extrapolated z_new can
    # overflow exp there and turn 0 * inf into NaN
    logw = np.where(hist > 0, logw, -np.inf)
    w = hist * np.exp(logw)
    tot = w.sum()
    n_mean = float((n * w).sum() / tot)
    n_var = float((n * n * w).sum() / tot - n_mean ** 2)
    ess = float(tot ** 2 / ((hist * np.exp(logw) ** 2).sum() * hist.sum()))
    return {"n_mean": n_mean, "n_var": n_var, "ess": ess}


class GCMC:
    """The monatomic muVT app as a class: blocks with the drift invariant
    and N statistics.

    >>> g = GCMC(lj_system(1), params, activity=0.05, capacity=128)
    >>> st = g.init(box=8.0, n_init=24, n_chains=256)
    >>> st, stats = g.run_block(st, 2000)
    """

    def __init__(self, system, params, activity, capacity,
                 dtype=torch.float64, mega=None, device="cuda",
                 generator=None):
        self.params = params
        self.capacity = int(capacity)
        self._init, self.run_steps, self.full_energy = make_gcmc(
            system, params, activity, capacity, dtype, mega, device,
            generator)

    def init(self, box, n_init, n_chains):
        return self._init(box, n_init, n_chains)

    def run_block(self, state, n_steps, drift_tol=None):
        att0, acc0 = state.att, state.acc
        e_start = state.energy
        state = self.run_steps(state, n_steps)
        e = self.full_energy(state)
        # scale on both block endpoints (see mc/gcmc_mol.MolGCMC.run_block)
        scale = torch.clamp_min(torch.maximum(e.abs(), e_start.abs()), 1.0)
        drift = torch.max((e - state.energy).abs() / scale)
        n = state.active.sum(1).to(torch.float64)
        ratio = (state.acc - acc0) / torch.clamp_min(state.att - att0, 1)
        stats = {
            "n_mean": float(n.mean()),
            "n_var": float(n.var(unbiased=False)),
            "full_frac": float((n >= self.capacity).to(torch.float64)
                               .mean()),
            "energy_mean": float(e.mean()),
            "acc_trans": float(ratio[:, 0].mean()),
            "acc_insert": float(ratio[:, 1].mean()),
            "acc_delete": float(ratio[:, 2].mean()),
            "drift_max_rel": float(drift),
        }
        if drift_tol is not None and not (
                stats["drift_max_rel"] < drift_tol
                and math.isfinite(stats["energy_mean"])):
            raise RuntimeError(f"energy drift over {drift_tol}: {stats}")
        return dataclasses.replace(state, energy=e), stats
