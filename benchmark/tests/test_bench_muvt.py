"""The muVT cell at a CPU test's size (the port runs its sweep kernel's
plain version here): a run through the harness comes out correct with
its exact counts 0, traced or not, and reads the span metrics the CPU
can read; a program at twice the activity, or one that drops an inserted
molecule's S(k) row, does not come out correct; and muvt_bound matches a
count by hand."""

import copy
import math
import time

import pytest
import torch

from benchmark import harness, roofline, roofline_muvt, spec
from benchmark.reference.rigid_ewald import kvectors

import metropolismontecarlo_tpu_torch.ops.cuda.sweep_kernel as sweep_op

CELL = "muvt_spce512.liq500.b50"
SEED = 2 ** 31 + 77
CHUNK = 32


def tiny():
    """(config, traffic) of the cell with its scale cut: 8 slots in a 12 A
    box with one active at the start, a 4.4 A cutoff, a melt of 2 sweeps,
    128 chains, all of them checked, recompute chunks of CHUNK chains, 3
    warm blocks and blocks of 4 cycles, 256 insertion trials a chain;
    every other setting as the cell's files give it.  A box this small
    holds no liquid at 500 K: the chains are a dilute vapour (z V ~ 0.38),
    whose insertions are accepted with z V / (N + 1) < 1, so that a wrong
    activity moves the exchanges' acceptance.  (A dense start evaporates
    within a few cycles, its exchanges mostly accepted outright, min(1, a)
    at 1, and the acceptance of a few thousand attempts against states
    that change by the block is a test of nothing.)"""
    w = spec.workload(spec.benchmark(), CELL)
    c = copy.deepcopy(spec.config(w["config"]))
    t = copy.deepcopy(spec.traffic(w["traffic"]))
    cap = 8
    c["model"]["n_mol"] = c["capacity"] = cap
    c["box"], c["chunk"], c["melt_sweeps"] = 12.0, CHUNK, 2
    c["params"]["r_cut"] = 4.4
    x_per = round(cap * 0.3 / 0.7)
    t.update(chains=128, n_init=1, block_steps=4 * (cap + x_per),
             warm_blocks=3, check_chains=128)
    t["accept_trials"] = {"move": 64, "exchange": 256}
    return c, t


def _run(trace=0, seconds=1.0):
    c, t = tiny()
    return harness.run_cell(CELL, SEED, seconds, trace, "cpu",
                            time.perf_counter(), config=c, traffic=t)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_sound_run_is_correct():
    rec = _run()
    assert rec["correct"], rec["checked"]
    assert rec["failed"] == 0 and rec["attempted"] >= 2
    checked = rec["checked"]
    assert checked["exchange_attempts"]["value"] == 0
    assert checked["n_balance"]["value"] == 0
    assert {"acc_trans", "acc_rot", "acc_xfer"} <= set(checked)
    assert set(rec["metrics"]) == {"setup_s", "ensemble_moves_per_s"}


def test_traced_run_reads_the_span_metrics():
    """The timing pass's span metrics and the counting pass's chunks per
    recompute are read; the device metrics find nothing off the card and
    are left out."""
    rec = _run(trace=1, seconds=0.2)
    assert rec["correct"], rec["checked"]
    assert rec["checked"]["n_balance"]["value"] == 0
    names = {m["name"] for m in spec.per_layer(spec.benchmark(), CELL)}
    assert len(names) == 6
    assert set(rec["metrics"]) == {"driver.ms_per_cycle.muvt",
                                   "recompute.block_end_ms.muvt",
                                   "recompute.chunks_per_call.muvt"} <= names
    assert rec["metrics"]["recompute.chunks_per_call.muvt"]["value"] == \
        math.ceil(tiny()[1]["chains"] / CHUNK)
    assert rec["device"]["window_s"] > 0.0


def _twice_the_activity(orig):
    def broken(*args, **kw):
        if kw.get("n_exch"):
            kw["z"] = 2.0 * kw["z"]
        return orig(*args, **kw)
    return broken


def _drop_inserted_row(orig, config):
    """The op with the S(k) row of one newly active slot of each chain
    left out of the S(k) it returns."""
    model, p = config["model"], config["params"]
    q = torch.tensor([s["charge"] for s in model["sites"]])
    P = len(q)
    n_vec = torch.as_tensor(kvectors(p["nk"], p["ksq_max"])[0],
                            dtype=torch.float32)

    def broken(*args, **kw):
        out = list(orig(*args, **kw))
        if not kw.get("n_exch"):
            return tuple(out)
        new = (out[6] > 0.5) & (kw["actm"] < 0.5)              # (C, M)
        hit = new.any(1)
        slot = new.to(torch.int64).argmax(1)
        cols = slot[:, None] * P + torch.arange(P)[None, :]    # (C, P)
        x = out[0].gather(2, cols[:, None, :].expand(-1, 3, -1))
        phase = 2.0 * math.pi / args[4][:, None, None] \
            * torch.einsum("cdp,kd->cpk", x, n_vec)
        row = torch.stack([(q[None, :, None] * torch.cos(phase)).sum(1),
                           (q[None, :, None] * torch.sin(phase)).sum(1)],
                          -1)
        out[3] = out[3] - hit[:, None, None].to(row.dtype) * row
        return tuple(out)
    return broken


@pytest.mark.parametrize("fault", ["twice_the_activity",
                                   "inserted_row_dropped"])
def test_broken_exchanges_are_not_correct(fault, monkeypatch):
    """Twice the activity in the program: its exchanges accept otherwise
    than the reference expects at the configuration's activity (acc_xfer).
    An accepted insertion whose S(k) row is left out of the carried S(k):
    sk_carried."""
    orig = sweep_op.sweep
    if fault == "twice_the_activity":
        monkeypatch.setattr(sweep_op, "sweep", _twice_the_activity(orig))
        name = "acc_xfer"
    else:
        monkeypatch.setattr(sweep_op, "sweep",
                            _drop_inserted_row(orig, tiny()[0]))
        name = "sk_carried"
    rec = _run()
    assert not rec["correct"], rec["checked"]
    c = rec["checked"][name]
    assert c["value"] > c["limit"], rec["checked"]


def test_muvt_bound_against_a_count_by_hand(monkeypatch):
    """3-site molecules (one LJ site, three charges), 4 slots, 2 chains
    with 2 and 3 active, K 5, nk 2, frac 0.5, near 0.25, 3 attempts."""
    blk = roofline.Block(P=3, M=4, n_lj=1, n_q=3, coulomb="ewald", nk=2)
    monkeypatch.setattr(roofline_muvt, "bound", lambda b, o: (b, o))
    nbytes, ops = roofline_muvt.muvt_bound(blk, 2, 5, torch.tensor([2, 3]),
                                           0.5, 0.25, 3)
    # state 4 x 12 atoms + 8 x 4 slots + 2 x 5 = 90 words, in and out;
    # uniforms 10 x 4 + 8 x 3, constants 7, statistics 9: 260 words a chain
    assert nbytes == 4 * 2 * 260
    # a lane's pair cost 20 + 0.25 x 3 x 20 + 0.5 x (8 + 3 x 17) = 64.5;
    # moves: 2 poses x (2 x 1 + 3 x 2) pairs x 3 lanes, and 5 x (2 x 309 +
    # 5 x 8) k-space (k_pose_ops(5, 2, 3) = 309); attempts: 2 chains x 3
    # x ((2.5 - 0.5) x 3 x 64.5 + 309 + 40 + 0.5 x 2.5 x 90)
    assert roofline.k_pose_ops(5, 2, 3) == 309
    assert ops == pytest.approx(2 * 8 * 3 * 64.5 + 5 * 658
                                + 6 * (387 + 349 + 112.5), rel=1e-12)
    monkeypatch.undo()
    ms, what = roofline_muvt.muvt_bound(blk, 2, 5, torch.tensor([2, 3]),
                                        0.5, 0.25, 3)
    assert (ms, what) == roofline.bound(nbytes, ops)
