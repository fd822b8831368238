"""The acceptance reference (reference/rigid_moves.py) in float64 on the
CPU: a molecule's energy change from its pair and S(k) terms equals the
difference of two whole evaluations; its volume rule decides as the
port's volume move does on the same uniforms; and near equilibrium its
expected acceptance is what the port's sweeps accept."""

import copy

import pytest
import torch

from benchmark import spec, tracing
from benchmark.reference import rigid_ewald as rx
from benchmark.reference import rigid_moves as rm
from benchmark.tests.tiny import tiny

from metropolismontecarlo_tpu_torch.io.configs import cubic_lattice
from metropolismontecarlo_tpu_torch.mc.driver import MonteCarlo
from metropolismontecarlo_tpu_torch.models import water
from metropolismontecarlo_tpu_torch.models.system import RunParams

F64 = rx.Precision("float64")


def _random_config(config_name, M=16, L=9.0, rows=2, seed=3):
    cfg = copy.deepcopy(spec.config(config_name))
    cfg["params"]["r_cut"] = 4.4
    g = torch.Generator().manual_seed(seed)
    com = torch.rand(rows, M, 3, generator=g, dtype=torch.float64) * L
    q = torch.randn(rows, M, 4, generator=g, dtype=torch.float64)
    q = q / q.norm(dim=-1, keepdim=True)
    box = torch.full((rows,), L, dtype=torch.float64)
    return cfg, com, q, box


@pytest.mark.parametrize("config_name", ["spce750_ewald", "tip4p2005_750"])
def test_move_energy_matches_whole_evaluations(config_name):
    cfg, com, q, box = _random_config(config_name)
    mdl = rm._Model(cfg["model"], cfg["params"], "cpu")
    ev = rx.evaluate(com, q, box, None, cfg["model"], cfg["params"], F64)
    m = torch.tensor([[3], [5]])
    delta = torch.tensor([[0.2, -0.1, 0.3], [0.05, 0.1, -0.2]],
                         dtype=torch.float64)
    old = rm._gather(ev["sites"], m)
    new = old + delta[:, None, None, :]
    on = torch.ones(2, 1, com.shape[1], dtype=torch.bool)
    on[0, 0, 3] = on[1, 0, 5] = False
    du = mdl.pair(new, ev["sites"], on, box) \
        - mdl.pair(old, ev["sites"], on, box)
    o_re, o_im = mdl.sfac_rows(old, box)
    n_re, n_im = mdl.sfac_rows(new, box)
    du = du + mdl.recip_delta(ev["sfac"][..., 0], ev["sfac"][..., 1],
                              n_re - o_re, n_im - o_im, mdl.cf(box))
    com2 = com.clone()
    com2[0, 3] += delta[0]
    com2[1, 5] += delta[1]
    ev2 = rx.evaluate(com2, q, box, None, cfg["model"], cfg["params"], F64)
    want = ev2["energy"] - ev["energy"]
    assert torch.allclose(du[:, 0], want, rtol=1e-9,
                          atol=1e-9 * float(ev["energy"].abs().max()))


@pytest.mark.parametrize("config_name", ["spce750_ewald", "gibbs_spce128"])
def test_insertion_energy_matches_whole_evaluations(config_name):
    cfg, com, q, box = _random_config(config_name)
    M = com.shape[1]
    mdl = rm._Model(cfg["model"], cfg["params"], "cpu")
    act = torch.ones(2, M, dtype=torch.bool)
    act[:, 7] = False
    ev_all = rx.evaluate(com, q, box, None, cfg["model"], cfg["params"], F64)
    ev = rx.evaluate(com, q, box, act, cfg["model"], cfg["params"], F64)
    x = rm._gather(ev["sites"], torch.tensor([[7], [7]]))
    du = mdl.pair(x, ev["sites"], act[:, None, :], box)[:, 0]
    r_re, r_im = mdl.sfac_rows(x, box)
    du = du + mdl.recip_delta(ev["sfac"][..., 0], ev["sfac"][..., 1], r_re,
                              r_im, mdl.cf(box))[:, 0] \
        + mdl.self_intra(box) + mdl.lrc_coef(box) * (2 * (M - 1) + 1)
    want = ev_all["energy"] - ev["energy"]
    assert torch.allclose(du, want, rtol=1e-9,
                          atol=1e-9 * float(ev["energy"].abs().max()))


def test_npt_volume_rule_decides_as_the_port():
    c, t = tiny("spce750.npt.v20")
    p = c["params"]
    params = RunParams(temperature=c["temperature"], r_cut=p["r_cut"],
                       coulomb="ewald", kappa_L=p["kappa_L"], nk=p["nk"],
                       ksq_max=p["ksq_max"], use_lrc=True, dr_max=0.3,
                       dphi_max=0.3, pressure=rm.BAR_IN_K_PER_A3,
                       p_volume=0.5, dv_max=0.01)
    mc = MonteCarlo(water.spce_system(64), params, device="cpu",
                    dtype=torch.float64, kernel="plain",
                    generator=torch.Generator().manual_seed(4))
    st = mc.init_state(cubic_lattice(64, c["box"]), box=c["box"],
                       n_chains=4)
    st = mc.run_steps(st, 4)
    u = torch.linspace(0.02, 0.98, 4, dtype=torch.float64)
    u_acc = torch.full((4,), 0.5, dtype=torch.float64)
    moved = mc._volume_move.with_uniforms(st, u, u_acc).box != st.box
    mdl = rm._Model(c["model"], p, "cpu")
    ev = rx.evaluate(st.com, st.quat, st.box, None, c["model"], p, F64)
    dlnv = (2.0 * u - 1.0) * 0.01
    box_new = st.box * torch.exp(dlnv / 3.0)
    e_new = rm._scaled_energy(mdl, st.com, st.quat, st.box, box_new, None,
                              8)
    arg = -(e_new - ev["energy"] + rm.BAR_IN_K_PER_A3
            * (box_new ** 3 - st.box ** 3)) / c["temperature"] + 65 * dlnv
    assert moved.tolist() == (arg > torch.log(u_acc)).tolist()
    assert 0 < int(moved.sum()) < 4


def test_expected_acceptance_near_equilibrium():
    """After a melt of 30 sweeps the port's translations and rotations
    over 6 blocks accept within 2% of what the reference expects at the
    blocks' ends."""
    seed = 5
    c, t = tiny("spce750.nvt.b100")
    t.update(melt_sweeps=30, check_chains=8, chains=8)
    t["accept_trials"] = {"move": 512}
    cell = spec.ensemble(t["ensemble"]).Cell(c, t, seed, "cpu")
    cell.setup()
    cell.install(tracing.Spans("cpu"))
    for _ in range(6):
        cell.block()
    info = cell.acceptance()
    gen = rm.seeded(seed, "cpu")
    per_state = [rm.expected("fixed_n", st, c, info["moves"], info["trials"],
                             gen) for st in info["states"]]
    for kind in ("trans", "rot"):
        acc, att = info["realized"][kind]
        p = sum(s[kind] for s in per_state) / len(per_state)
        assert abs(acc / att / p - 1.0) < 0.02, (kind, acc / att, p)
