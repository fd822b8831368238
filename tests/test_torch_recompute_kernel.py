"""The full-energy recompute kernel (ops/cuda/recompute_kernel.py) and its
route in MonteCarlo._energies.

On the CPU:
* the gate (mc/moves.py recompute_kernel_supported) over device, dtype,
  cutoff mode, LJ shift, Coulomb form, surface term, atom count, tp_mesh
  and the kernel's table limits;
* a CPU MonteCarlo keeps the chunked energy_breakdown and launches no
  kernel;
* the host tables of a tiny SPC/E box, a TIP4P/2005 box and a
  two-species mixture (per-atom info words, charges, LJ pair tables,
  k-vectors);
* the wrapper's assembly of the raw sums (self energy, LJ tail,
  reciprocal and intramolecular scaling) against energy_breakdown's
  terms; the wrapper refuses CPU tensors (energy_breakdown is the plain
  twin).

On the card (marker `cuda`; they skip without one): the kernel against
energy_breakdown in float64 on the card, for total, w and S(k), SPC/E at
per-chain boxes, TIP4P/2005, a species-block mixture, the linear LJ shift
and no Coulomb; rows of a full-batch launch bit-equal to a launch of those
rows alone, two launches bit-equal; a chain-sharded NPT run_block equal to
the unsharded one bit for bit; one kernel launch per recompute of a
run_block and no chunk inside it; no spill and three blocks an SM at the
benchmark's flagship and TIP4P/2005-750 shapes.  Run them on a machine with the card
(without JAX: tests/conftest.py imports it, so it is left out):
`python -m pytest tests/test_torch_recompute_kernel.py --noconftest -m
cuda -q`.
"""

import contextlib
import dataclasses

import numpy as np
import pytest
import torch

from metropolismontecarlo_tpu_torch.io.configs import cubic_lattice
from metropolismontecarlo_tpu_torch.mc import driver as driver_mod
from metropolismontecarlo_tpu_torch.mc.driver import MonteCarlo
from metropolismontecarlo_tpu_torch.mc.moves import recompute_kernel_supported
from metropolismontecarlo_tpu_torch.models import water
from metropolismontecarlo_tpu_torch.models.energy import energy_breakdown
from metropolismontecarlo_tpu_torch.models.system import RunParams
from metropolismontecarlo_tpu_torch.ops import ewald
from metropolismontecarlo_tpu_torch.ops.cuda import recompute_kernel as rop
from metropolismontecarlo_tpu_torch.utils import profiling
from metropolismontecarlo_tpu_torch.utils.constants import COULOMB_FACTOR
from metropolismontecarlo_tpu_torch.utils.shard import shard_context

F64 = torch.float64
EWALD = dict(temperature=298.15, coulomb="ewald", kappa_L=5.6, nk=5,
             ksq_max=27, strict_min_image=False)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One thread per test process leaves the cores to the other test
    processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def card():
    """The CUDA device, or a skip without one (decided here, never at
    import)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the recompute kernel is CUDA")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


class Recorder:
    """A span sink that keeps (name, units, sync, parent name)."""

    def __init__(self):
        self.spans, self._open = [], []

    @contextlib.contextmanager
    def span(self, name, units, sync):
        self.spans.append((name, units, sync,
                           self._open[-1] if self._open else None))
        self._open.append(name)
        try:
            yield
        finally:
            self._open.pop()


@contextlib.contextmanager
def recording():
    rec = Recorder()
    profiling.attach(rec)
    try:
        yield rec
    finally:
        profiling.detach()


# ---------------- systems ----------------

def spce(n=27):
    return water.spce_system(n)


def tip4p(n=27):
    return water.tip4p2005_system(n)


def mixture(n_w=20, n_ch4=7):
    return water.spce_methane_system(n_w, n_ch4)


SYSTEMS = {"spce": spce, "tip4p2005": tip4p, "spce+ch4": mixture}
# name -> (system builder, RunParams overrides)
CASES = {
    "spce": (spce, {}),
    "tip4p2005": (tip4p, {}),
    "spce+ch4": (mixture, {}),
    "spce linear": (spce, dict(lj_shift="linear", use_lrc=False)),
    "spce none": (spce, dict(coulomb="none")),
}


def params_for(box, **kw):
    return RunParams(**dict(EWALD, r_cut=min(9.0, 0.5 * box - 0.1), **kw))


def states(system, params, box, n_chains, device, dtype, seed=3):
    """A lattice start with random orientations on n_chains chains, each
    chain's box (and COMs) scaled by its own factor, as after volume
    moves: (mc, coords, com, boxes)."""
    gen = torch.Generator(device=device).manual_seed(seed)
    mc = MonteCarlo(system, params, device=device, generator=gen,
                    dtype=dtype)
    st = mc.init_state(cubic_lattice(system.n_mol, box), box=box,
                       n_chains=n_chains)
    scale = torch.linspace(0.98, 1.02, n_chains, dtype=dtype,
                           device=device)
    com = st.com * scale[:, None, None]
    return mc, mc.build_coords(com, st.quat), com, st.box * scale


# ---------------- the gate ----------------

GATE = {
    # name: (RunParams overrides, system, device, dtype, tp_mesh, expected)
    "card f32 ewald": ({}, "spce", "cuda", torch.float32, None, True),
    "cpu": ({}, "spce", "cpu", torch.float32, None, False),
    "float64": ({}, "spce", "cuda", F64, None, False),
    "com cutoff": (dict(cutoff_mode="com"), "spce", "cuda", torch.float32,
                   None, False),
    "first cutoff": (dict(cutoff_mode="first"), "spce", "cuda",
                     torch.float32, None, False),
    "linear shift": (dict(lj_shift="linear"), "spce", "cuda",
                     torch.float32, None, True),
    "unknown shift": (dict(lj_shift="quadratic"), "spce", "cuda",
                      torch.float32, None, False),
    "no coulomb": (dict(coulomb="none"), "spce", "cuda", torch.float32,
                   None, True),
    "wolf": (dict(coulomb="wolf"), "spce", "cuda", torch.float32, None,
             False),
    "bare": (dict(coulomb="bare"), "spce", "cuda", torch.float32, None,
             False),
    "surface term": (dict(ewald_surface=True), "spce", "cuda",
                     torch.float32, None, False),
    "4095 atoms": ({}, "spce1365", "cuda", torch.float32, None, True),
    "4098 atoms": ({}, "spce1366", "cuda", torch.float32, None, False),
    "tp_mesh": ({}, "spce", "cuda", torch.float32, "mesh", False),
    "tip4p2005": ({}, "tip4p2005", "cuda", torch.float32, None, True),
    "mixture": ({}, "spce+ch4", "cuda", torch.float32, None, True),
    "33 types": ({}, "33 types", "cuda", torch.float32, None, False),
    "nk 128": (dict(nk=128), "spce", "cuda", torch.float32, None, False),
    "nk 128 no coulomb": (dict(nk=128, coulomb="none"), "spce", "cuda",
                          torch.float32, None, True),
}


def gate_system(name):
    if name.startswith("spce1"):
        return water.spce_system(int(name[4:]))
    if name == "33 types":
        s = spce()
        return dataclasses.replace(s, eps_table=np.zeros((33, 33)),
                                   sig_table=np.ones((33, 33)))
    return SYSTEMS[name]()


@pytest.mark.parametrize("name", list(GATE))
def test_gate_truth_table(name):
    kw, sysname, device, dtype, mesh, expected = GATE[name]
    params = RunParams(**dict(EWALD, **kw))
    mesh = object() if mesh else None
    assert recompute_kernel_supported(gate_system(sysname), params, dtype,
                                      device, mesh) is expected


def test_cpu_montecarlo_takes_energy_breakdown(monkeypatch):
    """The gate refuses the CPU: init and run_block recompute through the
    chunked energy_breakdown, and no kernel launch is counted."""
    calls = []

    def counting(*args, **kw):
        calls.append(args[2].shape[0])
        return energy_breakdown(*args, **kw)

    monkeypatch.setattr(driver_mod, "energy_breakdown", counting)
    system = spce(8)
    params = params_for(9.0, use_lrc=False)
    launches = rop.recompute_kernel.launches
    mc = MonteCarlo(system, params, device="cpu", dtype=F64,
                    recompute_chunk=2,
                    generator=torch.Generator().manual_seed(0))
    assert mc._recompute_tables is None
    state = mc.init_state(cubic_lattice(8, 9.0), box=9.0, n_chains=3)
    with recording() as rec:
        mc.run_block(state, 1)
    assert rop.recompute_kernel.launches == launches
    assert calls == [2, 1, 2, 1]          # init and the block end, chunked
    names = [s[0] for s in rec.spans]
    assert "recompute.kernel" not in names
    assert [s[3] for s in rec.spans if s[0] == "chunk"] == ["recompute"] * 2


# ---------------- the host tables ----------------

@pytest.mark.parametrize("name", list(SYSTEMS))
def test_host_tables(name):
    system = SYSTEMS[name]()
    params = params_for(15.0)
    kv, kw = ewald.make_kvectors(params.nk, params.ksq_max)
    t = rop.recompute_tables(system, params, kv, kw, "cpu")
    A = system.n_atoms
    assert (t.A, t.A_pad, t.M, t.T, t.K, t.nk) == (
        A, system.n_atoms_padded, system.n_mol, system.eps_table.shape[0],
        len(kv), params.nk)
    assert t.ewald and not t.linear and t.use_lrc
    assert t.rc2 == pytest.approx(params.r_cut ** 2)
    info = t.info.long().numpy()
    mol, slot = system.atom_mol_slot
    tid = system.flat(system.type_ids)
    q = system.flat(system.charges)
    eps = np.asarray(system.eps_table)
    np.testing.assert_array_equal(info >> rop.INFO_MOL, mol)
    np.testing.assert_array_equal((info >> rop.INFO_TYPE) & 31, tid)
    np.testing.assert_array_equal(info & 1, np.any(eps != 0, 1)[tid])
    np.testing.assert_array_equal((info >> 1) & 1, q != 0)
    np.testing.assert_array_equal(t.q.numpy(), q.astype(np.float32))
    np.testing.assert_array_equal(t.ljt[0].numpy(), eps.astype(np.float32))
    np.testing.assert_allclose(t.ljt[1].numpy(),
                               np.asarray(system.sig_table) ** 2, rtol=1e-6)
    assert not t.ljt[2:].any()
    np.testing.assert_array_equal(t.kvec.numpy(), kv)
    np.testing.assert_array_equal(t.kw.numpy(), kw)
    np.testing.assert_array_equal(t.type_counts.numpy(), system.type_counts)
    # no Coulomb: no charged flags, no k-vectors
    t0 = rop.recompute_tables(system, params_for(15.0, coulomb="none"),
                              None, None, "cpu")
    assert not (t0.info & 2).any() and (t0.K, t0.nk, t0.ewald) == (0, 0,
                                                                    False)
    if name == "tip4p2005":
        # the massless M site: charged, no LJ; the O: LJ, uncharged
        assert info[3] & 3 == 2 and info[0] & 3 == 1


def test_linear_shift_tables():
    """lam1 = eps l1 and lam2 = eps l2 / sigma on LJ pairs, zero
    elsewhere."""
    from metropolismontecarlo_tpu_torch.ops.lj import _shift_coeffs

    system = mixture()
    params = params_for(15.0, lj_shift="linear", use_lrc=False)
    lam = rop.pair_tables(system, params)
    eps, sig = np.asarray(system.eps_table), np.asarray(system.sig_table)
    l1, l2 = _shift_coeffs(params.r_cut / sig)
    on = eps != 0
    np.testing.assert_allclose(lam[2][on], (eps * l1)[on])
    np.testing.assert_allclose(lam[3][on], (eps * l2 / sig)[on])
    assert not lam[2:, ~on].any()


def test_recompute_kernel_checks_its_inputs():
    system = spce(8)
    params = params_for(9.0)
    kv, kw = ewald.make_kvectors(params.nk, params.ksq_max)
    t = rop.recompute_tables(system, params, kv, kw, "cpu")
    coords = torch.zeros((2, 3, t.A_pad))
    com, box = torch.zeros((2, 8, 3)), torch.full((2,), 9.0)
    with pytest.raises(ValueError, match="com: shape"):
        rop.recompute_kernel(t, coords, com[:, :7], box)
    with pytest.raises(ValueError, match="dtype"):
        rop.recompute_kernel(t, coords.half(), com, box)
    with pytest.raises(ValueError, match="no chains"):
        rop.recompute_kernel(t, coords[:0], com[:0], box[:0])
    # CPU tensors of the right shapes: energy_breakdown is the plain twin
    with pytest.raises(ValueError, match="CUDA tensors"):
        rop.recompute_kernel(t, coords, com, box)


@pytest.mark.parametrize("name", list(CASES))
def test_assemble_matches_energy_breakdown_terms(name):
    """The wrapper's assembly of the kernel's raw sums, fed energy_breakdown's
    own pair, intramolecular and reciprocal energies at per-chain boxes,
    gives energy_breakdown's total: the self energy and the LJ tail it adds
    and the scaling of the intra and S(k) sums follow the plain route.  With
    the virial sums zero, w is the tail's 3 E_lrc plus the reciprocal
    energy and the self energy (their exact volume derivatives' share)."""
    build, kw = CASES[name]
    system = build()
    params = params_for(15.0, **kw)
    mc, coords, com, boxes = states(system, params, 15.0, 3, "cpu", F64)
    A = system.n_atoms
    ref = energy_breakdown(system, params, coords[:, :, :A].transpose(1, 2),
                           com, boxes, mc.kvecs, mc.kweights)
    t = rop.recompute_tables(system, params, mc.kvecs, mc.kweights, "cpu")
    zero = torch.zeros_like(boxes)
    raw = torch.stack([ref["disp"], zero, ref["coul_real"], zero,
                       -ref["coul_intra"], zero,
                       ref["coul_fourier"] / COULOMB_FACTOR, zero], -1)
    total, w = rop.assemble(t, raw, boxes)
    # the tables' float32 charges round E_self at ~5e-8
    scale = torch.maximum(ref["total"].abs(), ref["coul_self"].abs())
    w_ref = 3.0 * ref["lrc"] + ref["coul_fourier"] + ref["coul_self"]
    assert ((total - ref["total"]).abs() / scale).max() <= 1e-6
    assert ((w - w_ref).abs() / scale).max() <= 1e-6
    assert bool((ref["lrc"] != 0).all()) is t.use_lrc
    assert bool((ref["coul_self"] != 0).all()) is t.ewald


# ---------------- on the card ----------------

CARD_BOX = 18.64          # 216 waters near 1 g/cm^3


def card_case(name, device, n_chains=16):
    build, kw = CASES[name]
    system = build(216) if name != "spce+ch4" else build(180, 36)
    params = params_for(CARD_BOX, **kw)
    return system, params, states(system, params, CARD_BOX, n_chains,
                                  device, torch.float32)


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(CASES))
def test_kernel_matches_energy_breakdown_in_float64(card, name):
    """The kernel in float32 against energy_breakdown in float64 on the
    same float32 configurations, per-chain boxes: energies within 2e-5 of
    max(|E|, |E_self|) and virials within 2e-5 of max(|E|, |W|, |E_self|)
    (the plain float32 route reads ~6e-6 at the flagship; without Coulomb
    the LJ virial's magnitude exceeds the energy's), S(k) within 1e-4 of
    the sum of |q|."""
    system, params, (mc, coords, com, boxes) = card_case(name, card)
    assert mc._recompute_tables is not None
    n0 = rop.recompute_kernel.launches
    e, w, s = mc._energies(coords, com, boxes)
    torch.cuda.synchronize()
    assert rop.recompute_kernel.launches == n0 + 1
    A = system.n_atoms
    ref = energy_breakdown(system, params,
                           coords[:, :, :A].transpose(1, 2).double(),
                           com.double(), boxes.double(), mc.kvecs,
                           mc.kweights)
    scale_e = torch.maximum(ref["total"].abs(), ref["coul_self"].abs())
    scale_w = torch.maximum(scale_e, ref["w"].abs())
    de = ((e.double() - ref["total"]).abs() / scale_e).max().item()
    dw = ((w.double() - ref["w"]).abs() / scale_w).max().item()
    qsum = float(np.abs(system.flat(system.charges)).sum())
    ds = (s.double() - ref["sfac"]).abs().max().item() / max(qsum, 1.0)
    print(f"{name}: energy {de:.3e}, virial {dw:.3e}, S(k) {ds:.3e}")
    assert de <= 2e-5 and dw <= 2e-5 and ds <= 1e-4


@pytest.mark.cuda
def test_kernel_rows_and_repeats_are_bit_equal(card):
    """Rows a:b of a full-batch launch equal a launch of those rows alone,
    and a second launch equals the first: no reduction depends on the
    batch."""
    system, params, (mc, coords, com, boxes) = card_case("spce", card)
    t = mc._recompute_tables
    full = rop.recompute_kernel(t, coords, com, boxes)
    again = rop.recompute_kernel(t, coords, com, boxes)
    part = rop.recompute_kernel(t, coords[5:11], com[5:11], boxes[5:11])
    one = rop.recompute_kernel(t, coords[7:8], com[7:8], boxes[7:8])
    for f, a, p, o in zip(full, again, part, one):
        assert torch.equal(f, a)
        assert torch.equal(f[5:11], p)
        assert torch.equal(f[7:8], o)


def npt_mc(device, seed=11):
    system = spce(216)
    params = params_for(CARD_BOX, pressure=0.0145, p_volume=0.5,
                        dv_max=0.01, use_lrc=True)
    gen = torch.Generator(device=device).manual_seed(seed)
    return MonteCarlo(system, params, device=device, generator=gen)


@pytest.mark.cuda
def test_sharded_npt_run_block_matches_unsharded(card):
    """Two shards of 8 chains (chain-global draws, utils/shard.py) end a
    run_block of 4 sweeps with 2 volume moves where the unsharded 16
    chains end, bit for bit."""
    C, L = 16, 8
    lattice = cubic_lattice(216, CARD_BOX)
    mc = npt_mc(card)
    full = mc.init_state(lattice, box=CARD_BOX, n_chains=C)
    full, _ = mc.run_block(full, 4)
    parts = []
    for c0 in (0, L):
        mc = npt_mc(card)
        with shard_context(c0, C):
            st = mc.init_state(lattice, box=CARD_BOX, n_chains=L)
            st, _ = mc.run_block(st, 4)
        parts.append(st)
    assert int(full.att[:, 2].sum()) == 2 * C
    for f in dataclasses.fields(full):
        a = getattr(full, f.name)
        if f.name == "step":
            assert all(torch.equal(a, p.step) for p in parts)
            continue
        b = torch.cat([getattr(p, f.name) for p in parts])
        assert torch.equal(a, b), f.name


@pytest.mark.cuda
def test_run_block_launches_one_kernel_per_recompute(card):
    """A run_block with a volume move: every recompute (the volume move's
    and the block end's) is one kernel launch inside a `recompute.kernel`
    span, with no chunk and no energy phase inside the recompute."""
    mc = npt_mc(card)
    state = mc.init_state(cubic_lattice(216, CARD_BOX), box=CARD_BOX,
                          n_chains=16)
    n0 = rop.recompute_kernel.launches
    with recording() as rec:
        mc.run_block(state, 2)
    names = [s[0] for s in rec.spans]
    assert names.count("recompute") == 2
    assert rop.recompute_kernel.launches == n0 + 2
    kernel = [s for s in rec.spans if s[0] == "recompute.kernel"]
    assert kernel == [("recompute.kernel", 16, False, "recompute")] * 2
    assert not any(s[3] == "recompute" and s[0] != "recompute.kernel"
                   for s in rec.spans)
    assert "chunk" not in names and "energy.real" not in names


@pytest.mark.cuda
@pytest.mark.parametrize("builder,P", [("spce_system", 3),
                                       ("tip4p2005_system", 4)])
def test_kernel_occupancy_at_the_benchmark_shapes(card, builder, P):
    """750 molecules at r_cut 10 with Ewald (the benchmark's flagship and
    TIP4P/2005-750 shapes): no local memory, three blocks an SM, eik tiles
    of 58 sites at nk 5, the shared bytes the C side counts."""
    system = getattr(water, builder)(750)
    params = RunParams(**dict(EWALD, r_cut=10.0))
    t = rop.recompute_tables(system, params, *ewald.make_kvectors(
        params.nk, params.ksq_max), card)
    regs, local, blocks, smem, tile = rop.occupancy(t)
    print(f"{builder}: {regs} registers, {local} B local, {blocks} blocks "
          f"an SM, {smem} B shared, eik tiles of {tile} sites")
    assert (local, blocks, tile) == (0, 3, 58)
    assert system.atoms_per_mol == P and 3 * (smem + 1024) <= 228 * 1024
