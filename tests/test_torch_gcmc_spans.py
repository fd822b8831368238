"""The muVT app's spans (mc/gcmc_mol.py, utils/profiling.py) on the CPU,
where both kernel routes run the sweep kernel's plain version.

A tiny `MolGCMC.run_block` of two cycles on the in-kernel route
(mega="full") and on the hybrid route (mega=True), with a recording sink
attached: one `gcmc.cycle` per cycle, of the chains; on the hybrid route
one `gcmc.exchange` per cycle, of chains x x_per; one `recompute` of the
chains around the block-end `full_energy`, with ceil(chains / chunk)
`chunk` spans under it whose rows sum to the chains.  The final states
are bit-identical with and without the sink.
"""

import contextlib
import dataclasses
import math

import pytest
import torch

from metropolismontecarlo_tpu_torch.mc.gcmc_mol import MolGCMC
from metropolismontecarlo_tpu_torch.models.system import RunParams
from metropolismontecarlo_tpu_torch.models.water import spce_system
from metropolismontecarlo_tpu_torch.ops import ewald
from metropolismontecarlo_tpu_torch.utils import profiling

CAP, BOX, CHAINS, CHUNK, PX = 16, 9.0, 4, 3, 0.3
X_PER = max(1, int(round(CAP * PX / (1.0 - PX))))
CYCLES = 2
KL, NK, KSQ = ewald.tune_parameters(BOX, 4.0, 1e-3)
PARAMS = RunParams(temperature=500.0, r_cut=4.0, cutoff_mode="site",
                   coulomb="ewald", kappa_L=KL, nk=NK, ksq_max=KSQ,
                   use_lrc=False, p_translate=0.5, dr_max=0.3, dphi_max=0.3,
                   strict_min_image=False)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One thread per test process leaves the cores to the other test
    processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class Recorder:
    """A sink that keeps (name, units, sync, parent index) per span."""

    def __init__(self):
        self.spans, self._open = [], []

    @contextlib.contextmanager
    def span(self, name, units, sync):
        parent = self._open[-1] if self._open else None
        self.spans.append((name, units, sync, parent))
        self._open.append(len(self.spans) - 1)
        try:
            yield
        finally:
            self._open.pop()

    def named(self, name):
        return [i for i, s in enumerate(self.spans) if s[0] == name]


def _block(mega):
    """Two cycles of CHAINS chains from a lattice start, then the
    block-end recompute; the sink attached only for run_block."""
    g = MolGCMC(spce_system(CAP), PARAMS, activity=2e-3, p_exchange=PX,
                dtype=torch.float32, chunk=CHUNK, mega=mega, device="cpu",
                generator=torch.Generator().manual_seed(11))
    state = g.init(box=BOX, n_init=10, n_chains=CHAINS)
    return lambda: g.run_block(state, CYCLES * (CAP + X_PER))[0]


@pytest.fixture(scope="module", params=["full", "hybrid"])
def runs(request):
    """(route, plain state, traced state, recorder) of one route."""
    mega = "full" if request.param == "full" else True
    plain = _block(mega)()
    block = _block(mega)
    rec = Recorder()
    profiling.attach(rec)
    try:
        traced = block()
    finally:
        profiling.detach()
    return request.param, plain, traced, rec


def test_one_cycle_span_per_launch(runs):
    _, plain, _, rec = runs
    cycles = rec.named("gcmc.cycle")
    assert len(cycles) == CYCLES
    assert all(rec.spans[i][1:] == (CHAINS, False, None) for i in cycles)
    # x_per exchange attempts of every chain a cycle, on both routes
    assert int(plain.att[:, 2:].sum()) == CYCLES * X_PER * CHAINS


def test_exchange_spans_on_the_hybrid_route(runs):
    route, plain, _, rec = runs
    ex = rec.named("gcmc.exchange")
    if route == "full":
        assert ex == []
        return
    assert len(ex) == CYCLES
    assert all(rec.spans[i][1:] == (CHAINS * X_PER, False, None)
               for i in ex)


def test_one_recompute_with_its_chunks(runs):
    _, _, _, rec = runs
    recs = rec.named("recompute")
    assert len(recs) == 1
    i = recs[0]
    assert rec.spans[i][1:] == (CHAINS, True, None)
    chunks = [j for j in rec.named("chunk") if rec.spans[j][3] == i]
    assert len(chunks) == math.ceil(CHAINS / CHUNK)
    assert sum(rec.spans[j][1] for j in chunks) == CHAINS
    assert not any(rec.spans[j][2] for j in chunks)
    assert len(rec._open) == 0


def test_states_equal_with_and_without_sink(runs):
    _, plain, traced, _ = runs
    for f in dataclasses.fields(plain):
        a, b = getattr(plain, f.name), getattr(traced, f.name)
        if isinstance(a, torch.Tensor):
            assert torch.equal(a, b), f.name
