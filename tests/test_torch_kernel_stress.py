"""The Gibbs and flip kernels' stress cases (chip_smoke.py
gibbs_stress_cases and flip_stress_cases, held to sweep_gibbs_plain and
flip_plain on the card) really stress what they name, checked here on the
CPU from the states the card run builds (chip_smoke draws them on the CPU,
with the card run's seeds and chain count, and moves them to the card):
every site pair inside the cutoff, none inside it, split cutoffs, a Gibbs
box whose every atom lies within every pose's reach, one active slot in a
box or a species block."""

import pytest
import torch

import chip_smoke

GIBBS = {case[0]: i for i, case in enumerate(chip_smoke.gibbs_stress_cases())}
FLIP = {case[0]: i for i, case in enumerate(chip_smoke.flip_stress_cases())}


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _gibbs(tag):
    (_, system, params, boxes, _, _), inputs = \
        chip_smoke.gibbs_stress_inputs("cpu", GIBBS[tag])
    return system, params, boxes, inputs


def _gibbs_fractions(system, inputs, r_cut):
    args, actm = inputs[0], inputs[4]
    return chip_smoke._gibbs_cutoff_fraction(system, args[0], actm > 0.5,
                                             args[4], r_cut)


def _flip(tag):
    case, (args, tables, _, _, _) = chip_smoke.flip_stress_inputs(
        "cpu", FLIP[tag])
    return case, args, tables


def _flip_fraction(system, args, r_cut):
    """Share of the pairs of active atoms of different molecules within
    r_cut over every chain of a flip state (coords, ..., act, actm)."""
    coords, box, act = args[0], args[4], args[6]
    mol = torch.as_tensor(system.atom_mol_slot[0])
    A = mol.numel()
    x = coords[:, :, :A].transpose(1, 2)
    d = x[:, :, None, :] - x[:, None, :, :]
    d = d - box[:, None, None, None] * torch.round(d / box[:, None, None,
                                                              None])
    on = act[:, :A] > 0.5
    pair = on[:, :, None] & on[:, None, :] & (mol[:, None] != mol[None, :])
    return float(((d * d).sum(-1) < r_cut ** 2)[pair].float().mean())


def test_gibbs_every_site_pair_lies_inside_the_cutoff():
    system, params, boxes, inputs = _gibbs("all pairs in cutoff spce32 wolf")
    assert params.r_cut >= max(boxes) * 3 ** 0.5 / 2
    assert _gibbs_fractions(system, inputs, params.r_cut) == [1.0, 1.0]


def test_gibbs_dilute_boxes_have_no_site_pair_inside_the_cutoff():
    system, params, _, inputs = _gibbs("dilute spce32 ewald")
    assert _gibbs_fractions(system, inputs, params.qq_cut) == [0.0, 0.0]


def test_gibbs_split_cutoffs_differ_in_the_kernel_tables():
    system, params, _, inputs = _gibbs("split cutoff spce32 ewald")
    t = inputs[2][0]
    assert t.rc2 == pytest.approx(4.5 ** 2) and t.qrc2 == pytest.approx(36.0)
    lj = _gibbs_fractions(system, inputs, params.r_cut)
    qq = _gibbs_fractions(system, inputs, params.qq_cut)
    for b in range(2):
        assert 0.0 < lj[b] < qq[b] < 1.0


def test_gibbs_box_0_holds_every_atom_within_reach_not_every_pair_live():
    system, params, boxes, inputs = _gibbs(
        "reach holds every atom spce32 ewald")
    args, actm = inputs[0], inputs[4]
    r_cut = max(params.r_cut, params.qq_cut)
    assert r_cut < boxes[0] * 3 ** 0.5 / 2
    com = args[1]
    near = [chip_smoke._reach_fraction(
        args[0][:, b], com[:, b], system.atom_mol_slot[0], args[4][:, b],
        r_cut, actm[:, b] > 0.5)[0] for b in range(2)]
    assert near[0] == 1.0 and near[1] < 1.0
    assert _gibbs_fractions(system, inputs, r_cut)[0] < 1.0


def test_gibbs_box_0_holds_one_active_slot():
    _, _, _, inputs = _gibbs("one active slot spce32 ewald")
    actm = inputs[4]
    assert bool((actm[:, 0].sum(1) == 1.0).all())
    assert bool((actm[:, 1].sum(1) >= 1.0).all())


def test_flip_every_site_pair_lies_inside_the_cutoff():
    (_, system, params, box, _, _), args, _ = _flip(
        "all pairs in cutoff spce 32+32 wolf")
    assert params.r_cut >= box * 3 ** 0.5 / 2
    assert _flip_fraction(system, args, params.r_cut) == 1.0


def test_flip_dilute_box_has_no_site_pair_inside_the_cutoff():
    (_, system, params, _, _, _), args, _ = _flip("dilute spce 32+32 ewald")
    assert _flip_fraction(system, args, params.qq_cut) == 0.0


def test_flip_split_cutoffs_differ_in_the_kernel_tables():
    (_, system, params, _, _, _), args, tables = _flip(
        "split cutoff spce 32+32 ewald")
    assert tables.a.rc2 == pytest.approx(4.5 ** 2)
    assert tables.a.qrc2 == pytest.approx(36.0)
    lj = _flip_fraction(system, args, params.r_cut)
    qq = _flip_fraction(system, args, params.qq_cut)
    assert 0.0 < lj < qq < 1.0


def test_flip_species_a_holds_one_active_slot():
    _, args, tables = _flip("one active A slot spce 32+32 ewald")
    actm = args[7]
    assert bool((actm[:, :tables.a.M].sum(1) == 1.0).all())
