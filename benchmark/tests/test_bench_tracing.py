"""The trace reduction on a made-up trace: busy time is the union of the
device intervals inside the window, idle gaps are named by the innermost
host span, and kernel time is picked by name."""

from types import SimpleNamespace

import pytest

from benchmark import tracing


class _Ev:
    def __init__(self, name, kind, dev, t0, t1):
        self._v = (name, kind, dev, t0, t1)

    def name(self):
        return self._v[0]

    def activity_type(self):
        return self._v[1]

    def device_type(self):
        return self._v[2]

    def start_ns(self):
        return self._v[3]

    def end_ns(self):
        return self._v[4]


def _prof(events):
    res = SimpleNamespace(events=lambda: events)
    return SimpleNamespace(profiler=SimpleNamespace(kineto_results=res))


def test_busy_idle_and_kernels():
    ev = [_Ev("window", "user_annotation", "DeviceType.CPU", 0, 1000),
          _Ev("run_steps", "user_annotation", "DeviceType.CPU", 0, 600),
          _Ev("full_energy", "user_annotation", "DeviceType.CPU", 600, 1000),
          _Ev("void sweep_kernel<3>", "kernel", "DeviceType.CUDA", 100, 300),
          _Ev("elementwise", "kernel", "DeviceType.CUDA", 250, 400),
          _Ev("Memcpy DtoH", "gpu_memcpy", "DeviceType.CUDA", 700, 800),
          _Ev("window", "gpu_user_annotation", "DeviceType.CUDA", 0, 1000),
          _Ev("cudaLaunchKernel", "cuda_runtime", "DeviceType.CPU", 90, 95),
          _Ev("late", "kernel", "DeviceType.CUDA", 950, 1200)]
    tr = tracing.Trace(_prof(ev))
    assert tr.window_s == pytest.approx(1e-6)
    assert tr.busy() == [[100, 400], [700, 800], [950, 1000]]
    assert tr.busy_s == pytest.approx(450e-9)
    assert tr.kernel_s("sweep_kernel") == pytest.approx(200e-9)
    gaps = tr.idle_gaps()
    assert gaps[0] == ["run_steps", pytest.approx(300e-9)]
    assert [g[0] for g in gaps] == ["run_steps", "full_energy", "run_steps"]
    assert [g[1] for g in gaps] == pytest.approx([300e-9, 150e-9, 100e-9])
    assert tr.device_ops()[0][0] == "void sweep_kernel<3>"


def test_device_only_trace_takes_the_callers_window():
    ev = [_Ev("void sweep_kernel<3>", "kernel", "DeviceType.CUDA", 100, 300),
          _Ev("elementwise", "kernel", "DeviceType.CUDA", 250, 400),
          _Ev("late", "kernel", "DeviceType.CUDA", 900, 1300)]
    tr = tracing.Trace(_prof(ev), window=None, window_s=1e-6)
    assert tr.window_s == pytest.approx(1e-6)
    assert tr.busy() == [[100, 400], [900, 1100]]
    assert tr.kernel_s("sweep") == pytest.approx(200e-9)


def test_spans_by_mode():
    sp = tracing.Spans("cpu")
    with sp.span("run_steps", 3):
        pass
    assert sp.records == []
    sp.mode = "time"
    with sp.span("run_steps", 5):
        pass
    with sp.span("run_steps", 7):
        pass
    sp.mode = "count"
    with sp.span("run_steps", 11):
        pass
    sp.mode = "note"
    with sp.span("full_energy", 1):
        pass
    s, units, n = sp.total("run_steps")
    assert units == 12 and n == 2 and s >= 0.0
    assert sp.total("run_steps", "count") == (0.0, 11, 1)
    assert sp.total("full_energy", "note") == (0.0, 1, 1)
    sp.mode = "loud"
    with pytest.raises(ValueError):
        with sp.span("run_steps", 1):
            pass


def test_traced_run_on_the_cpu():
    """A `--trace 1` run's three passes at test size: the timing pass's
    span metrics are read, the device metrics find nothing off the card
    and are left out, and the record carries the device pass's window
    and the noting pass's idle gaps."""
    import time

    from benchmark import harness, spec
    from benchmark.tests.tiny import tiny

    workload = "spce750.npt.v20"
    c, t = tiny(workload)
    rec = harness.run_cell(workload, 2 ** 31 + 9, 0.2, 1, "cpu",
                           time.perf_counter(), config=c, traffic=t)
    assert rec["attempted"] >= 3
    names = {m["name"] for m in spec.per_layer(spec.benchmark(), workload)}
    assert set(rec["metrics"]) == {"driver.ms_per_sweep.npt",
                                   "recompute.block_end_ms.npt"} <= names
    assert rec["device"]["window_s"] > 0.0
    assert rec["breakdown"]["idle_gaps"]
