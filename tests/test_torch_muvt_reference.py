"""The port's muVT main path against the benchmark's plain float64
references, on the CPU.

* `MolGCMC(mega="full")` in float32 (the sweep kernel's plain version
  here) runs a few cycles of SPC/E with Ewald; the energy and S(k) it
  carried into the block-end recompute, and those the recompute gave, are
  held against `benchmark/reference/rigid_ewald.py` in float64 on the
  chains' own configurations (the sites rebuilt from centres and
  quaternions), as the benchmark's check holds them.
* `benchmark/reference/muvt_moves.py` on the ideal rigid rotor (no LJ, no
  charges): every trial's dU is 0, so the insertion and deletion
  acceptances are min(1, z V / (N + 1)) and min(1, N / (z V)), and every
  displacement is accepted.
"""

import math

import pytest
import torch

from benchmark.reference import muvt_moves
from benchmark.reference.rigid_ewald import Precision, evaluate
from benchmark.reference.rigid_moves import _Model
from metropolismontecarlo_tpu_torch.mc.gcmc_mol import MolGCMC
from metropolismontecarlo_tpu_torch.models.system import RunParams
from metropolismontecarlo_tpu_torch.models.water import spce_system

F64 = Precision("float64")
CAP, BOX, CHAINS, Z = 27, 9.0, 6, 2.2e-4
X_PER = round(CAP * 0.3 / 0.7)
EWALD = {"r_cut": 4.4, "cutoff_mode": "site", "coulomb": "ewald",
         "kappa_L": 5.6, "nk": 5, "ksq_max": 27, "use_lrc": False}
SITES = [{"name": "O", "mass": 15.999, "charge": -0.8476,
          "sigma": 3.16555789, "epsilon": 78.19743111},
         {"name": "H", "mass": 1.008, "charge": 0.4238},
         {"name": "H", "mass": 1.008, "charge": 0.4238}]
GEOMETRY = {"kind": "water3", "r_oh": 1.0, "theta_deg": 109.47}
# float32 sums: the carried energy is the recompute's plus three cycles of
# accepted float32 deltas, each a pair sum of ~10^2 terms and a
# reciprocal delta over K 337; their rounding reads ~3e-8 of the scale
# max(|E|, |E_self|) (the self term, the largest of the sum), and 2e-6
# (~30 float32 ulps of the scale) leaves a factor ~70 for other seeds
E_TOL = 2e-6
# S(k) over sqrt(N sum q^2): float32 sites (~5e-7 A off, at k up to
# 2 pi 5 / 9 A^-1) and ~10^2 accepted row updates read ~6e-6; 1e-4
# leaves a factor ~16
SK_TOL = 1e-4
# sites rebuilt from the float32 centres and quaternions, Angstrom: the
# reading ~5e-7 is float32 rounding of coordinates up to ~10 A
X_TOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _gaps(com, quat, box, active, coords, energy, sfac):
    """(sites, energy, S(k)) gaps of float32 chains against the float64
    reference, scaled as the benchmark's check scales them."""
    model = {"sites": SITES, "geometry": GEOMETRY}
    ref = evaluate(com, quat, box, active, model, EWALD, F64)
    C = com.shape[0]
    sites = coords[:, :, :CAP * 3].transpose(1, 2).reshape(C, CAP, 3, 3)
    d = (sites.double() - ref["sites"]).abs().amax(-1)
    d = torch.where(active[:, :, None], d, 0.0)
    scale_e = torch.maximum(ref["energy"].abs(), ref["self_energy"].abs())
    q2 = sum(s["charge"] ** 2 for s in SITES)
    scale_s = torch.sqrt(active.sum(1).double() * q2)
    ds = torch.linalg.vector_norm(sfac.double() - ref["sfac"], dim=-1) \
        .amax(-1)
    return (float(d.max()),
            float(((energy.double() - ref["energy"]).abs() / scale_e).max()),
            float((ds / scale_s).max()))


@pytest.fixture(scope="module")
def block():
    params = RunParams(temperature=500.0, p_translate=0.5, dr_max=0.4,
                       dphi_max=0.4, strict_min_image=False, lj_shift="none",
                       **EWALD)
    g = MolGCMC(spce_system(CAP), params, activity=Z, p_exchange=0.3,
                dtype=torch.float32, chunk=4, mega="full", device="cpu",
                generator=torch.Generator().manual_seed(23))
    state = g.init(box=BOX, n_init=18, n_chains=CHAINS)
    seen = {}
    inner = g.full_energy

    def full_energy(st):
        seen["carried"] = st
        return inner(st)

    g.full_energy = full_energy
    end, _ = g.run_block(state, 3 * (CAP + X_PER))
    return seen["carried"], end


def test_block_moved_and_exchanged(block):
    carried, end = block
    assert int(end.att[:, 2:].sum()) == 3 * X_PER * CHAINS
    assert int(end.acc[:, 2:].sum()) > 0
    assert int(end.acc[:, :2].sum()) > 0
    assert torch.equal(end.active, carried.active)


@pytest.mark.parametrize("which", ["carried", "resync"])
def test_energy_and_sfac_against_the_reference(block, which):
    carried, end = block
    st = carried if which == "carried" else end
    dx, de, dsk = _gaps(carried.com, carried.quat, carried.box,
                        carried.active, carried.coords, st.energy, st.sfac)
    assert dx < X_TOL
    assert de < E_TOL
    assert dsk < SK_TOL


def test_ideal_rotor_acceptance_in_closed_form():
    model = {"sites": [dict(s, charge=0.0, epsilon=0.0) for s in SITES],
             "geometry": GEOMETRY}
    params = dict(EWALD, r_cut=4.0)
    config = {"model": model, "params": params, "temperature": 300.0,
              "activity": 0.05}
    gen = torch.Generator().manual_seed(5)
    B, M, box = 5, 12, torch.full((5,), 6.0, dtype=torch.float64)
    com = torch.rand((B, M, 3), generator=gen, dtype=torch.float64) * 6.0
    quat = torch.randn((B, M, 4), generator=gen, dtype=torch.float64)
    quat = quat / quat.norm(dim=-1, keepdim=True)
    n = torch.tensor([0, 3, 9, 11, 12])
    active = torch.arange(M)[None, :] < n[:, None]
    st = {"com": com, "quat": quat, "box": box, "active": active}
    mdl = _Model(model, params, com.device)
    ev = evaluate(com, quat, box, active, model, params, F64)
    zv = 0.05 * 6.0 ** 3
    p_ins = muvt_moves.insertion(mdl, st, ev, 300.0, 0.05, 64, gen)
    p_del = muvt_moves.deletion(mdl, st, ev, 300.0, 0.05)
    nf = n.double()
    want_ins = torch.where(n < M, torch.clamp_max(zv / (nf + 1.0), 1.0), 0.0)
    want_del = torch.where(n > 0, torch.clamp_max(nf / zv, 1.0), 0.0)
    # exp(log a): equal up to the rounding of the two functions
    torch.testing.assert_close(p_ins, want_ins, rtol=1e-14, atol=0.0)
    torch.testing.assert_close(p_del, want_del, rtol=1e-14, atol=0.0)
    moves = {"dr_max": 0.5, "dphi_max": 0.5, "p_translate": 0.5}
    out = muvt_moves.expected("muvt", st, config, moves,
                              {"move": 16, "exchange": 64}, gen)
    assert out["trans"] == 1.0 and out["rot"] == 1.0
    assert math.isclose(out["xfer"],
                        float((0.5 * (want_ins + want_del)).mean()),
                        rel_tol=1e-14)
