"""The port's spans in the benchmark (port_spans.py): the idle share
inside a span on a made-up trace, PortSpans's parents and sync=False
spans in each mode, and the traced passes of the tiny cells with the
port's spans attached, their chunk counts exact."""

import math
from types import SimpleNamespace

import pytest

from benchmark import port_spans, tracing
from benchmark.tests.test_bench_tracing import _Ev, _prof
from benchmark.tests.tiny import CELLS, tiny


def test_idle_share_inside_a_span():
    ev = [_Ev("window", "user_annotation", "DeviceType.CPU", 0, 1000),
          _Ev("recompute", "user_annotation", "DeviceType.CPU", 100, 500),
          _Ev("recompute", "user_annotation", "DeviceType.CPU", 600, 1200),
          _Ev("chunk", "user_annotation", "DeviceType.CPU", 100, 300),
          _Ev("chunk", "user_annotation", "DeviceType.CPU", 250, 480),
          _Ev("k", "kernel", "DeviceType.CUDA", 50, 250),
          _Ev("k", "kernel", "DeviceType.CUDA", 200, 220),
          _Ev("k", "kernel", "DeviceType.CUDA", 700, 800),
          _Ev("k", "kernel", "DeviceType.CUDA", 950, 1100)]
    tr = tracing.Trace(_prof(ev))
    # recompute: [100, 500] + [600, 1000] clipped, 800 ns; busy inside
    # [100, 250] + [700, 800] + [950, 1000], 300 ns
    assert port_spans.idle_share_in(tr, "recompute") \
        == pytest.approx(1.0 - 300 / 800)
    # chunk: the union [100, 480], busy [100, 250]
    assert port_spans.idle_share_in(tr, "chunk") \
        == pytest.approx(1.0 - 150 / 380)
    assert port_spans.idle_share_in(tr, "volume_move") is None
    # the gaps, named by the innermost span at their midpoints
    assert tr.idle_gaps() == [["chunk", pytest.approx(450e-9)],
                              ["recompute", pytest.approx(150e-9)],
                              ["window", pytest.approx(50e-9)]]
    quiet = tracing.Trace(_prof(ev[:5]))
    assert port_spans.idle_share_in(quiet, "recompute") is None


def test_note_trace_without_activity_types():
    """A torch that reports no activity type: the port's spans on the host
    become notes, their ranges on the card are no device work, and the
    gaps are named by them."""
    ev = [_Ev("window", None, "DeviceType.CPU", 0, 1000),
          _Ev("full_energy", None, "DeviceType.CPU", 0, 1000),
          _Ev("recompute", None, "DeviceType.CPU", 0, 1000),
          _Ev("chunk", None, "DeviceType.CPU", 100, 600),
          _Ev("energy.setup", None, "DeviceType.CPU", 100, 300),
          _Ev("aten::add", None, "DeviceType.CPU", 110, 120),
          _Ev("chunk", None, "DeviceType.CUDA", 100, 900),
          _Ev("full_energy", None, "DeviceType.CUDA", 0, 1000),
          _Ev("k", None, "DeviceType.CUDA", 0, 150),
          _Ev("k", None, "DeviceType.CUDA", 600, 1000)]
    plain = tracing.Trace(_prof(ev))
    assert plain.busy() == [[0, 1000]]
    tr = port_spans.note_trace(_prof(ev))
    assert tr.busy() == [[0, 150], [600, 1000]]
    assert sorted(n[2] for n in tr.notes) == ["chunk", "energy.setup",
                                              "full_energy", "recompute"]
    assert tr.idle_gaps() == [["chunk", pytest.approx(450e-9)]]
    assert port_spans.idle_share_in(tr, "recompute") \
        == pytest.approx(0.45)


def _nest(sp):
    with sp.span("full_energy", 1):
        with sp.span("recompute", 6):
            for rows in (4, 2):
                with sp.span("chunk", rows, sync=False):
                    with sp.span("energy.real", 1, sync=False):
                        pass


@pytest.mark.parametrize("mode,names", [
    ("quiet", []),
    ("time", ["recompute", "full_energy"]),
    ("count", ["energy.real", "chunk", "energy.real", "chunk", "recompute",
               "full_energy"]),
    ("note", ["energy.real", "chunk", "energy.real", "chunk", "recompute",
              "full_energy"])])
def test_port_spans_parents_and_sync_by_mode(mode, names):
    sp = port_spans.PortSpans("cpu", mode)
    _nest(sp)
    assert [r[1] for r in sp.records] == names
    parents = {"full_energy": None, "recompute": "full_energy",
               "chunk": "recompute", "energy.real": "chunk"}
    for r in sp.records:
        assert r[0] == mode and r[5] == parents[r[1]]
    assert sp._open == []
    if mode == "count":
        assert [r[4] for r in sp.records if r[1] == "chunk"] == [4, 2]
        assert port_spans.chunks_per_call(sp) == 2.0
    if mode == "time":
        assert port_spans.chunks_per_call(sp) is None
        assert sp.total("recompute")[2] == 1


def test_port_spans_survive_an_error():
    sp = port_spans.PortSpans("cpu", "count")
    with pytest.raises(RuntimeError):
        with sp.span("recompute", 2):
            raise RuntimeError("inside")
    assert sp._open == [] and sp.records == []
    sp.mode = "loud"
    with pytest.raises(ValueError):
        with sp.span("chunk", 1, sync=False):
            pass


def test_readings_name_the_cells_kind():
    sp = port_spans.PortSpans("cpu", "time")
    with sp.span("volume_move", 1):
        pass
    note = SimpleNamespace(notes=[], device=[], t0=0, t1=1)
    got = port_spans.readings("npt", sp, note)
    assert set(got) == {"volume.ms_per_move.npt",
                        "recompute.chunks_per_call.npt",
                        "recompute.idle_share.npt"}
    assert got["volume.ms_per_move.npt"] >= 0.0
    assert got["recompute.chunks_per_call.npt"] is None
    assert got["recompute.idle_share.npt"] is None


@pytest.mark.parametrize("workload", CELLS)
def test_traced_passes_read_the_port_spans(workload, monkeypatch):
    """The tiny cell's three passes with the port's spans: the volume
    moves timed where the cell has them, the chunks under each recompute
    counted exactly (fixed-N recomputes cut to 3 chains a chunk, the
    Gibbs cell at 5 chains), the idle share left out off the card, and
    the noting pass's gaps named."""
    from metropolismontecarlo_tpu_torch.mc import driver
    from metropolismontecarlo_tpu_torch.utils import profiling

    monkeypatch.setattr(driver, "_auto_recompute_chunk",
                        lambda *a, **k: 3)
    c, t = tiny(workload)
    if t["ensemble"] == "gibbs":
        t["chains"] = 5               # 10 boxes: two chunks of up to 8
    rec = port_spans.run(workload, 2 ** 31 + 11, 0.2, "cpu", config=c,
                         traffic=t)
    kind = port_spans.KIND[t["rate"]]
    rows, chunk = (2 * t["chains"], 8) if kind == "gibbs" \
        else (t["chains"], 3)
    m = rec["metrics"]
    assert m[f"recompute.chunks_per_call.{kind}"] == math.ceil(rows / chunk)
    assert (f"volume.ms_per_move.{kind}" in m) == (kind != "sweeps")
    assert f"recompute.idle_share.{kind}" not in m
    assert set(rec["span_metrics"]) == (
        {"driver.ms_per_cycle.gibbs", "recompute.block_end_ms.gibbs"}
        if kind == "gibbs" else
        {"driver.ms_per_sweep.npt", "recompute.block_end_ms.npt"}
        if kind == "npt" else
        {"driver.ms_per_sweep", "recompute.block_end_ms.sweeps"})
    assert set(rec["walls"]) == {"time", "count", "note"}
    assert rec["idle_gaps"]
    assert profiling._sink is None
