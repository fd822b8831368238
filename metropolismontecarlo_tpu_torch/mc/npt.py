"""NPT volume move with a full-energy recompute (counterpart of
metropolismontecarlo_tpu/mc/npt.py).

Move: a symmetric random walk in ln V.  Molecular COMs scale by
s = (V'/V)^(1/3); rigid molecules translate with their COM, orientations
fixed.  The energy at the new volume is recomputed from scratch through
the driver's chunked full-energy route (dense or row-tiled), which carries
every box-dependent term (kappa = kappa_L / box, cfac, self and intra).
Acceptance:

  P_acc = min(1, exp(-beta (dU + P dV) + (M + 1) ln(V'/V)))

(the +1 from sampling in ln V).  A proposal below the minimum-image wall
(box < 2 cutoff, with strict_min_image) is rejected and counted as an
attempt.  `step` is not advanced: it stays a pure molecule-move counter,
so the driver's deterministic schedule (one attempt per chain every
round(1/p_volume) sweeps) reads the sweep index from it.  Both uniforms
of an attempt come from the caller (the driver's generator);
`volume_move_with` takes them explicitly.
"""

import dataclasses

import torch

from metropolismontecarlo_tpu_torch.ops.pbc import cube_root
from metropolismontecarlo_tpu_torch.utils.profiling import span
from metropolismontecarlo_tpu_torch.utils.shard import chain_rows, rand_chains


def make_volume_move_fn(system, params, energy_fn, build_coords,
                        pressure=None):
    """Returns volume_move(state, generator) -> state; its
    volume_move.with_uniforms(state, u_lnv, u_acc) is the same move on
    given (C,) uniforms.

    energy_fn(coords, com, box) -> (energy, virial, sfac) over the chain
    batch; build_coords(com, quat) -> (C, 3, A_pad) atoms.  pressure
    overrides params.pressure: a scalar, or a (C,) ladder running every
    chain at its own pressure (under a shard context also of the global
    chain count: utils/shard.py chain_rows)."""
    M = system.n_mol
    pres_src = params.pressure if pressure is None else pressure
    max_cut = float(max(params.r_cut, params.qq_cut))

    def move(state, u_lnv, u_acc):
        C = state.com.shape[0]
        pres = torch.as_tensor(pres_src, dtype=state.box.dtype,
                               device=state.box.device)
        # a scalar, or a ladder's rows of these chains
        pres = chain_rows(pres, C, "pressure ladder")
        dlnv = (2.0 * u_lnv - 1.0) * state.dv_max
        vol_old = state.box ** 3
        vol_new = vol_old * torch.exp(dlnv)
        box_new = cube_root(vol_new)       # batch-invariant (ops/pbc.py)
        com_new = state.com * (box_new / state.box)[:, None, None]
        coords_new = build_coords(com_new, state.quat)
        e_new, w_new, sfac_new = energy_fn(coords_new, com_new, box_new)

        d_e = e_new - state.energy
        arg = -(d_e + pres * (vol_new - vol_old)) / state.temp \
            + (M + 1.0) * torch.log(vol_new / vol_old)
        legal = torch.ones_like(arg, dtype=torch.bool)
        if params.strict_min_image:
            legal = box_new >= 2.0 * max_cut - 1e-9
        accept = legal & ((arg > 0.0) | (u_acc < torch.exp(
            torch.clamp_max(arg, 0.0))))

        def sel(new, old):
            return torch.where(
                accept.reshape((C,) + (1,) * (new.dim() - 1)), new, old)

        acc = state.acc.clone()
        att = state.att.clone()
        att[:, 2] += 1
        acc[:, 2] += accept.to(acc.dtype)
        return dataclasses.replace(
            state, com=sel(com_new, state.com),
            coords=sel(coords_new, state.coords),
            box=torch.where(accept, box_new, state.box),
            energy=torch.where(accept, e_new, state.energy),
            virial=torch.where(accept, w_new, state.virial),
            sfac=sel(sfac_new, state.sfac) if params.coulomb == "ewald"
            else state.sfac,
            acc=acc, att=att)

    def with_uniforms(state, u_lnv, u_acc):
        with span("volume_move"):
            return move(state, u_lnv, u_acc)

    def volume_move(state, generator):
        # chain-global under a shard context (utils/shard.py)
        u = rand_chains((state.com.shape[0], 2), generator, state.box.dtype,
                        state.box.device)
        return with_uniforms(state, u[:, 0], u[:, 1])

    volume_move.with_uniforms = with_uniforms
    return volume_move
