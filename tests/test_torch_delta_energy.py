"""The per-move route on the CPU: the delta-energy op's stress cases, its
alignment contract, and the sweep graph's copy-in / copy-out path.

* chip_smoke.py's delta_energy stress cases (delta_stress_cases, held to
  the kernel on the card) stress what they name, checked here on the CPU
  from the states the card run builds (chip_smoke draws them on the CPU,
  with the card run's seeds and chain count, and moves them to the card):
  every lane within the moved rows' reach and every pair inside the
  cutoff, no lane within reach, split cutoffs, rows with charge and no
  LJ, P = 1, R = 32.
* delta_energy_plain on those states (their first 8 chains) against the
  JAX package's delta_energy_pallas run by the TPU interpreter: e_lj and
  e_coul within 3e-5 of the row's term magnitudes (the Pallas kernel's
  rational erfc is ~1.7e-5 of them off a float64 evaluation, the port's
  f32 plain ~2e-7: tests/test_torch_moves.py), overlap counts equal.
* The wrapper refuses planes the kernel cannot read as 16-byte vectors,
  with the reason.
* MonteCarlo.move_sweep (mc/moves.py MoveSweepGraph's buffers; on the CPU
  they go through run_moves, without a graph) equals the bodies called
  one by one, bit for bit, and a sweep after dr_max and temp change sees
  the new values; with any MOVE_FIELDS field left out of the buffers a
  sweep goes wrong.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from metropolismontecarlo_tpu.ops.pallas.delta_energy import (
    delta_energy_pallas,
)
from metropolismontecarlo_tpu_torch.io.configs import cubic_lattice
from metropolismontecarlo_tpu_torch.mc import moves
from metropolismontecarlo_tpu_torch.mc.driver import MonteCarlo
from metropolismontecarlo_tpu_torch.models.linear import co2_n2_system
from metropolismontecarlo_tpu_torch.ops.cuda import delta_energy as delta_op

CASES = {case[0]: i for i, case in enumerate(chip_smoke.delta_stress_cases())}
FIELDS = moves.MOVE_FIELDS


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _case(tag):
    (_, system, box, params, m), state, args, P = \
        chip_smoke.delta_stress_inputs("cpu", CASES[tag])
    return system, params, m, state, args, P


def _pair_d2(args):
    """(C, R, A_pad) minimum-image d^2 of the moved rows and the lanes, and
    the (A_pad,) mask of the lanes of other molecules."""
    x, y, z, mx, my, mz, box, m = args[:8]
    b = box[:, None, None]
    d2 = 0.0
    for plane, rows in ((x, mx), (y, my), (z, mz)):
        dd = plane[:, None, :] - rows[:, :, None]
        dd = dd - b * torch.round(dd / b)
        d2 = d2 + dd * dd
    molid = args[14]
    return d2, (molid >= 0) & (molid != m)


def _live(args):
    return (args[11] != 0) | (args[12] != 0)


def _near(system, state, params, m):
    return chip_smoke._reach_fraction(
        state.coords, state.com, system.atom_mol_slot[0], state.box,
        max(params.r_cut, params.qq_cut), m_ranges=[(m, 1)])[0]


def test_every_lane_lies_within_reach_and_every_pair_inside_the_cutoff():
    system, params, m, state, args, _ = _case(
        "every lane in reach and cutoff spce64 wolf")
    d2, other = _pair_d2(args)
    live = _live(args)
    assert bool((d2[:, live][:, :, other] < params.r_cut ** 2).all())
    assert _near(system, state, params, m) == 1.0


def test_the_dilute_box_has_no_lane_within_reach():
    system, params, m, state, args, _ = _case("dilute spce64 ewald")
    assert _near(system, state, params, m) == 0.0
    for out in delta_op.delta_energy_plain(*args):
        assert not bool(out.any())


def test_the_split_cutoffs_differ_and_both_cut_pairs():
    _, params, _, _, args, _ = _case("split cutoff co2/n2 32+32 ewald")
    assert (params.r_cut, params.qq_cut) == (4.5, 6.0)
    dp = args[16]
    assert dp.rc2 == pytest.approx(4.5 ** 2)
    assert dp.qrc2 == pytest.approx(36.0)
    d2, other = _pair_d2(args)
    pairs = d2[:, _live(args)][:, :, other]
    lj = float((pairs < dp.rc2).float().mean())
    qq = float((pairs < dp.qrc2).float().mean())
    assert 0.0 < lj < qq < 1.0


def test_the_water_rows_with_charge_and_no_lj():
    _, _, _, _, args, P = _case("rows without LJ spce64 ewald")
    has_lj, has_q = args[11], args[12]
    h_rows = (has_q != 0) & (has_lj == 0)
    assert int(h_rows.sum()) == 4 and P == 3     # two H per pose
    e_lj, e_coul, _ = delta_op.delta_energy_plain(*args)
    assert not bool(e_lj[:, h_rows].any())
    assert bool((e_coul[:, h_rows] != 0.0).any())


def test_the_one_site_case_has_two_live_rows_and_no_charge():
    _, _, _, _, args, P = _case("P = 1 lj256")
    assert P == 1 and args[3].shape[1] == 8
    assert int(_live(args).sum()) == 2
    assert args[16].coulomb == "none"


def test_the_ring_fills_32_rows():
    system, _, _, _, args, P = _case("R = 32 ring16x27 ewald")
    assert P == 16 and args[3].shape[1] == delta_op.MAX_ROWS == 32
    assert int(_live(args).sum()) == 32
    assert system.atoms_per_mol == 16


def _to_np(t):
    return t.numpy()


@pytest.mark.parametrize("tag", sorted(CASES))
def test_stress_state_plain_matches_jax_interpret(tag):
    _, _, m, _, args, P = _case(tag)
    n = 8
    a = [t[:n] if isinstance(t, torch.Tensor) and t.dim() == 2
         and t.shape[0] == args[0].shape[0] else t for t in args]
    a[6] = args[6][:n]
    dp = a[16]
    R, T = a[8].shape
    t_pad = 8
    eps = np.zeros((R, t_pad), np.float32)
    sig2 = np.zeros((R, t_pad), np.float32)
    eps[:, :T], sig2[:, :T] = _to_np(a[8]), _to_np(a[9])
    ref = delta_energy_pallas(
        *(jnp.asarray(_to_np(t)) for t in a[:7]), jnp.asarray(m, jnp.int32),
        jnp.asarray(eps), jnp.asarray(sig2), jnp.asarray(_to_np(a[10])),
        jnp.asarray(_to_np(a[13]), jnp.float32),
        jnp.asarray(_to_np(a[14]), jnp.float32), jnp.asarray(_to_np(a[15])),
        coulomb=dp.coulomb, n_types=T, n_used=2 * P,
        row_has_lj=tuple(bool(v) for v in _to_np(a[11])),
        row_has_q=tuple(bool(v) for v in _to_np(a[12])),
        d2_overlap=dp.d2_overlap, kappa_l=dp.kappa_l, rc2=dp.rc2,
        qrc2=dp.qrc2, wolf_rc=dp.wolf_rc, interpret=True)
    ref = [np.asarray(r) for r in ref]
    out = [_to_np(t) for t in delta_op.delta_energy_plain(*a)]
    # the rows' term magnitudes: |q| for the Coulomb sums; the LJ terms'
    # repulsive and attractive halves each taken positive
    a_abs = list(a)
    a_abs[10], a_abs[15] = a[10].abs(), a[15].abs()
    q_scale = _to_np(delta_op.delta_energy_plain(*a_abs)[1])
    d2, other = _pair_d2(a)
    d2 = torch.clamp_min(d2, 1e-4)
    tid = a[13].clamp(min=0).long()
    s6 = (a[9][:, tid] / d2) ** 3
    lj_mag = torch.where(other & (d2 < dp.rc2) & (a[11][:, None] != 0),
                         4.0 * a[8][:, tid] * (s6 * s6 + s6), 0.0).sum(-1)
    lj_scale = _to_np(lj_mag)
    assert np.all(np.abs(out[0] - ref[0]) <= 3e-5 * lj_scale + 1e-30)
    assert np.all(np.abs(out[1] - ref[1]) <= 3e-5 * q_scale + 1e-30)
    np.testing.assert_array_equal(out[2], ref[2])


@pytest.mark.parametrize("bad", ["base", "row stride"])
def test_the_wrapper_refuses_misaligned_planes(bad):
    _, _, _, _, args, _ = _case("split cutoff co2/n2 32+32 ewald")
    if bad == "base":
        args = chip_smoke.misaligned_planes(args)
        match = "16-byte boundary"
    else:
        C, A_pad = args[0].shape
        wide = torch.zeros((C, 3, A_pad + 2))
        for d in range(3):
            wide[:, d, :A_pad] = args[d]
        args = (wide[:, 0, :A_pad], wide[:, 1, :A_pad],
                wide[:, 2, :A_pad]) + tuple(args[3:])
        match = "multiples of 4"
    with pytest.raises(ValueError, match=match):
        delta_op.delta_energy(*args)


# ---------------- the sweep graph's buffers ---------------------------


def _mixture():
    """8 CO2/N2 molecules as one block of differing templates (the
    per-move route), Ewald, 4 chains."""
    system = dataclasses.replace(co2_n2_system(4, 4), species=None)
    box = 37.0 * (8 / 750) ** (1 / 3)
    params = chip_smoke.mixture_params(r_cut=4.0)
    gen = torch.Generator().manual_seed(11)
    mc = MonteCarlo(system, params, device="cpu", generator=gen)
    assert mc.route == "move"
    state = mc.init_state(cubic_lattice(8, box),
                          quat=chip_smoke.diagonal_quats(8), box=box,
                          n_chains=4)
    us = [moves.draw_uniforms(4, 8, gen, "cpu") for _ in range(3)]
    return mc, state, us


def _eager(mc, state, u):
    state = dataclasses.replace(state, com=state.com.clone(),
                                quat=state.quat.clone(),
                                coords=state.coords.clone())
    return moves.run_moves(mc.move_bodies, state, u)


def _same(a, b):
    return all(torch.equal(getattr(a, f), getattr(b, f)) for f in FIELDS)


def _changed(state):
    """state with larger steps, a lower temperature and a slightly larger
    box: every field the moves only read changes."""
    return dataclasses.replace(state, dr_max=state.dr_max * 3.0,
                               dphi_max=state.dphi_max * 3.0,
                               temp=state.temp * 0.05,
                               box=state.box * 1.001)


def test_the_graph_path_equals_the_bodies_bit_for_bit():
    mc, state, us = _mixture()
    got, want = state, state
    for u in us[1:]:
        got, want = mc.move_sweep(got, u), _eager(mc, want, u)
        assert _same(got, want)
    assert int(got.step) == 2 * 8
    assert int(got.acc.sum()) > 0
    with pytest.raises(ValueError, match="on the card"):
        mc.capture_sweep(state)                  # no graph on the CPU


def test_a_later_sweep_sees_new_step_sizes_and_temperature():
    mc, state, us = _mixture()
    first = mc.move_sweep(state, us[1])
    changed = dataclasses.replace(first, dr_max=first.dr_max * 3.0,
                                  temp=first.temp * 0.05)
    got = mc.move_sweep(changed, us[2])
    assert _same(got, _eager(mc, changed, us[2]))
    assert not _same(got, _eager(mc, first, us[2]))


def _two_sweeps(run, mc, state, us):
    """Two sweeps through `run` (a MoveSweepGraph or the bodies), every
    field the moves only read changed between them; the result and
    whether the input state came through untouched."""
    snap = {f: getattr(state, f).clone() for f in FIELDS}
    out = run(_changed(run(state, us[1])), us[2])
    intact = all(torch.equal(getattr(state, f), snap[f]) for f in FIELDS)
    return out, intact


@pytest.mark.parametrize("field", FIELDS)
def test_a_field_left_out_of_the_buffers_breaks_a_sweep(field, monkeypatch):
    mc, state, us = _mixture()
    want, _ = _two_sweeps(lambda s, u: _eager(mc, s, u), mc, state, us)
    graph = moves.MoveSweepGraph(mc.move_bodies, state, us[0],
                                 graph=False)
    got, intact = _two_sweeps(graph, mc, state, us)
    assert _same(got, want) and intact
    monkeypatch.setattr(moves, "MOVE_FIELDS",
                        tuple(f for f in FIELDS if f != field))
    graph = moves.MoveSweepGraph(mc.move_bodies, state, us[0],
                                 graph=False)
    got, intact = _two_sweeps(graph, mc, state, us)
    assert not (_same(got, want) and intact)
