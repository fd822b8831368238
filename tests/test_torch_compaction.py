"""The sweep kernel's compaction stress cases (chip_smoke.py
compaction_cases, held to sweep_plain on the card) really stress what
they name, checked here on the CPU from the states the card run builds:
every site pair inside the cutoff, none inside it, split cutoffs; and the
share of atoms within a pose's reach, which the card run's bounds count
site distances for (chip_smoke._reach_fraction), holds every atom that
has a site pair inside the cutoff."""

import warnings

import pytest
import torch

import chip_smoke
from metropolismontecarlo_tpu_torch.io.configs import cubic_lattice
from metropolismontecarlo_tpu_torch.mc.driver import MonteCarlo

CASES = {case[0]: case for case in chip_smoke.compaction_cases()}


def _state(tag):
    _, system, box, params, _ = CASES[tag]
    gen = torch.Generator().manual_seed(7)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        mc = MonteCarlo(system, params, device="cpu", generator=gen,
                        kernel="sweep")
        state = mc.init_state(cubic_lattice(system.n_mol, box), box=box,
                              n_chains=2)
    return system, box, params, mc, state


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_every_site_pair_lies_inside_the_cutoff():
    system, box, params, mc, state = _state("all pairs in cutoff spce64 wolf")
    assert params.r_cut >= box * 3 ** 0.5 / 2
    assert chip_smoke._cutoff_fraction(system, state, params.r_cut) == 1.0
    assert mc.route == "sweep" and mc.tables[0].W == 0


def test_the_dilute_box_has_no_site_pair_inside_the_cutoff():
    system, _, params, mc, state = _state("dilute spce64 ewald")
    assert chip_smoke._cutoff_fraction(system, state, params.qq_cut) == 0.0
    assert mc.route == "sweep" and mc.tables[0].W == 0


def test_the_split_cutoffs_differ_in_the_kernel_tables():
    system, _, params, mc, state = _state("split cutoff spce64 ewald")
    t = mc.tables[0]
    assert t.rc2 == pytest.approx(4.5 ** 2) and t.qrc2 == pytest.approx(36.0)
    lj = chip_smoke._cutoff_fraction(system, state, params.r_cut)
    qq = chip_smoke._cutoff_fraction(system, state, params.qq_cut)
    assert 0.0 < lj < qq < 1.0


def _reach_by_brute_force(system, state, r_cut, active):
    """(share of (molecule, atom of another molecule) pairs with a site
    pair inside r_cut, share within the molecule's reach) over every
    chain, from full distance tensors."""
    A = system.n_atoms
    x = state.coords[:, :, :A].transpose(1, 2)                   # (C, A, 3)
    com = state.com
    L = state.box[:, None, None, None]
    mol = torch.as_tensor(system.atom_mol_slot[0], dtype=torch.long)
    M = com.shape[1]
    own = mol[None, :] == torch.arange(M)[:, None]                  # (M, A)
    d = x[:, :, None, :] - x[:, None, :, :]
    d = d - L * torch.round(d / L)
    site_in = (d * d).sum(-1) < r_cut ** 2                      # (C, A, A)
    any_in = (own[None, :, :, None] & site_in[:, None]).any(2)  # (C, M, A)
    e = x[:, None, :, :] - com[:, :, None, :]
    e = e - L * torch.round(e / L)
    r = e.norm(dim=-1)                                            # (C, M, A)
    rad = torch.where(own[None], r, torch.zeros_like(r)).amax(-1)
    near = r < (r_cut + rad)[:, :, None]
    pair = active[:, :, None] & active[:, mol][:, None, :] & ~own[None]
    n = pair.sum().double()
    return float((any_in & pair).sum() / n), float((near & pair).sum() / n)


@pytest.mark.parametrize("tag", list(CASES))
def test_the_reach_share_holds_every_atom_with_a_pair_inside_the_cutoff(tag):
    system, _, params, _, state = _state(tag)
    pattern = CASES[tag][4]
    active = torch.ones(state.com.shape[:2], dtype=torch.bool) \
        if pattern is None else pattern[None].expand(2, -1)
    r_cut = max(params.r_cut, params.qq_cut)
    near = chip_smoke._reach_fraction(state.coords, state.com,
                                      system.atom_mol_slot[0], state.box,
                                      r_cut, active, n=2, rows=16)
    any_in, brute = _reach_by_brute_force(system, state, r_cut, active)
    assert near == [pytest.approx(brute, abs=1e-12)]
    assert any_in <= near[0]
    assert chip_smoke._cutoff_fraction(system, state, r_cut) <= near[0]
    if tag.startswith("all pairs"):
        assert near == [1.0]
    if tag.startswith("dilute"):
        assert near == [0.0]
