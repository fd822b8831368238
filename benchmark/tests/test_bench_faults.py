"""A run of each cell at a CPU test's size (the harness's look for a
card skipped: the port runs its kernels' plain versions here) with the
timed path broken underneath: `correct` comes out false for each fault
the cells can have, and true without one.  And the control: the
reference computed in TF32 in the program's place fails the cell's
limits."""

import time

import pytest
import torch

from benchmark import check, harness, spec, tracing
from benchmark.tests.tiny import CELLS, tiny

import metropolismontecarlo_tpu_torch.ops.cuda.gibbs_kernel as gibbs_op
import metropolismontecarlo_tpu_torch.ops.cuda.sweep_kernel as sweep_op

SEED = 2 ** 31 + 77


def _run(workload, seconds=0.2, sound=False):
    c, t = tiny(workload, sound)
    return harness.run_cell(workload, SEED, seconds, 0, "cpu",
                            time.perf_counter(), config=c, traffic=t)


def _keep_half(new, old):
    """The first half of the chains from new, the rest from old."""
    h = new.shape[0] // 2
    return torch.cat([new[:h], old[h:]])


# per op: the stats columns of accepted work (energy changes, accepted
# moves and transfers, the accepted-slot fingerprint), the position of
# the temperature among its arguments, and where its activity planes come
# in and go out (the Gibbs op)
_OPS = {"sweep": {"accepted": [0, 1, 2, 8], "temp": 5, "planes": ()},
        "gibbs": {"accepted": [0, 1, 2, 3, 6, 7], "temp": 5,
                  "planes": ((10, 5), (11, 6))}}


def _fault(kind, orig, n_state, op):
    """A broken kernel op: `unchanged` returns its state as it came with no
    work counted; `half` advances only the first half of the chains (the
    rest returned as they came, their counters untouched); `energy` and
    `coords` alter the answer where the kernel produces it: the energy
    change it reports, or one site of every chain; `reject` rejects every
    move and transfer while counting each attempt (the state as it came,
    the attempt columns kept); `accept_all` accepts every move (the op run
    at a temperature a million times the chains')."""
    o = _OPS[op]

    def broken(*args, **kw):
        if kind == "accept_all":
            args = list(args)
            args[o["temp"]] = args[o["temp"]] * 1.0e6
            return orig(*args, **kw)
        out = list(orig(*args, **kw))
        if kind == "unchanged":
            out[:n_state] = args[:n_state]
            out[n_state] = torch.zeros_like(out[n_state])
        elif kind == "reject":
            out[:n_state] = args[:n_state]
            for a, i in o["planes"]:
                out[i] = args[a]
            out[n_state] = out[n_state].clone()
            out[n_state][:, o["accepted"]] = 0.0
        elif kind == "half":
            for i in range(n_state):
                out[i] = _keep_half(out[i], args[i])
            out[n_state] = _keep_half(out[n_state],
                                      torch.zeros_like(out[n_state]))
        elif kind == "energy":
            out[n_state] = out[n_state].clone()
            out[n_state][:, 0] += 1.0e3
        elif kind == "coords":
            out[0] = out[0].clone()
            out[0][..., 0] += 0.3
        return tuple(out)

    return broken


def _is_gibbs(workload):
    return spec.traffic(spec.workload(spec.benchmark(), workload)
                        ["traffic"])["ensemble"] == "gibbs"


def _plant(monkeypatch, workload, kind):
    if _is_gibbs(workload):
        monkeypatch.setattr(gibbs_op, "sweep_gibbs",
                            _fault(kind, gibbs_op.sweep_gibbs, 4, "gibbs"))
    else:
        monkeypatch.setattr(sweep_op, "sweep",
                            _fault(kind, sweep_op.sweep, 4, "sweep"))


@pytest.mark.parametrize("workload", CELLS)
def test_sound_run_is_correct(workload):
    rec = _run(workload, seconds=2.0, sound=True)
    assert rec["correct"], rec["checked"]
    assert rec["failed"] == 0 and rec["attempted"] >= 1
    assert list(rec)[-1] == "checked"
    for k in ("correct", "attempted", "failed", "metrics", "device"):
        assert k in rec
    bench = spec.benchmark()
    assert set(rec["metrics"]) == {m["name"] for m in
                                   spec.end_to_end(bench, workload)}


@pytest.mark.parametrize("kind", ["unchanged", "half", "energy", "coords"])
@pytest.mark.parametrize("workload", CELLS)
def test_broken_path_is_not_correct(workload, kind, monkeypatch):
    _plant(monkeypatch, workload, kind)
    rec = _run(workload)
    assert not rec["correct"], rec["checked"]


@pytest.mark.parametrize("kind", ["reject", "accept_all"])
@pytest.mark.parametrize("workload", CELLS)
def test_wrong_acceptance_is_not_correct(workload, kind, monkeypatch):
    """A kernel that keeps its energies and counters right but rejects, or
    accepts, every move: the acceptance numbers fail it, whatever the
    energies read."""
    _plant(monkeypatch, workload, kind)
    rec = _run(workload)
    assert not rec["correct"], rec["checked"]
    made = ("acc_trans", "acc_rot", "acc_xfer")     # the kernels' moves
    acc = {k: v for k, v in rec["checked"].items() if k in made}
    assert len(acc) == 2 + _is_gibbs(workload)
    assert all(v["value"] > v["limit"] for v in acc.values()), acc
    if kind == "reject":
        assert rec["checked"]["attempts"]["value"] == 0


@pytest.mark.parametrize("workload", CELLS)
def test_control_fails_the_limits(workload):
    """The reference in TF32 in the program's place, on the program's
    configurations of a run: some number over its limit."""
    c, t = tiny(workload)
    cell = spec.ensemble(t["ensemble"]).Cell(c, t, SEED, "cpu")
    cell.setup()
    cell.install(tracing.Spans("cpu"))
    cell.block()
    rows = cell.check_rows()
    ctl = check.control_numbers(rows, c)
    ok, checked = check.judge(ctl, {}, spec.limits(workload))
    assert not ok, checked
    prog = check.program_numbers(rows, c)
    assert all(ctl[k] > 3.0 * prog[k] for k in prog), (prog, ctl)
