"""The port's spans (utils/profiling.py) on the CPU in float64.

* A tiny NPT `MonteCarlo.run_block` and a tiny `MolGibbsEnsemble.run_block`
  with a recording sink attached: one `volume_move` per scheduled volume
  move, one `recompute` per volume move and block end, ceil(n / chunk)
  `chunk` spans of the chains or boxes under each `recompute`, and the
  energy phases under each chunk.
* The final states of both runs are bit-identical with and without the
  sink.
* With no sink, `span()` hands back one shared object and calls nothing.
"""

import contextlib
import dataclasses
import math
import sys

import pytest
import torch

from metropolismontecarlo_tpu_torch.io.configs import cubic_lattice
from metropolismontecarlo_tpu_torch.mc.driver import MonteCarlo
from metropolismontecarlo_tpu_torch.mc.gibbs_mol import MolGibbsEnsemble
from metropolismontecarlo_tpu_torch.models.system import RunParams
from metropolismontecarlo_tpu_torch.models.water import spce_system
from metropolismontecarlo_tpu_torch.ops import ewald
from metropolismontecarlo_tpu_torch.utils import profiling

F64 = torch.float64
KL, NK, KSQ = ewald.tune_parameters(13.0, 4.5, 1e-3)
WATER = dict(temperature=500.0, r_cut=4.5, cutoff_mode="site",
             coulomb="ewald", kappa_L=KL, nk=NK, ksq_max=KSQ, use_lrc=False,
             p_translate=0.5, dr_max=0.2, dphi_max=0.2,
             strict_min_image=False)
PHASES = {"energy.setup", "energy.real", "energy.kspace"}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One thread per test process leaves the cores to the other test
    processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class Recorder:
    """A sink that keeps (name, units, sync, parent index) per span, the
    parent being the innermost span open when it started."""

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

    def children(self, i, name):
        return [j for j, s in enumerate(self.spans)
                if s[3] == i and s[0] == name]


def _npt():
    """An NPT block of 4 sweeps, a volume move every second one: 5 chains
    recomputed in chunks of 2."""
    M, box, C, n = 27, 9.6, 5, 4
    params = RunParams(**WATER, pressure=1e-4, p_volume=0.5, dv_max=0.01)
    mc = MonteCarlo(spce_system(M), params, device="cpu", dtype=F64,
                    generator=torch.Generator().manual_seed(3),
                    recompute_chunk=2)
    state = mc.init_state(cubic_lattice(M, box), box=box, n_chains=C)
    return (lambda: mc.run_block(state, n)[0]), n // 2, C, 2


def _gibbs():
    """A Gibbs block of 8 plain steps, a volume move every fourth: 4
    chains of two boxes recomputed in chunks of 3 boxes."""
    C, n = 4, 8
    params = RunParams(**WATER, p_volume=0.25)
    g = MolGibbsEnsemble(spce_system(8), params, dv_max=0.02,
                         p_transfer=0.3, dtype=F64, chunk=3, device="cpu",
                         generator=torch.Generator().manual_seed(4))
    state = g.init(boxes=(11.0, 13.0), n_init=(6, 2), n_chains=C)
    return (lambda: g.run_block(state, n)[0]), n // 4, 2 * C, 3


ENSEMBLES = {"npt": _npt, "gibbs": _gibbs}


@pytest.fixture(scope="module", params=sorted(ENSEMBLES))
def runs(request):
    """The ensemble's block run from the same start without a sink and
    with a Recorder attached: (plain state, traced state, recorder,
    scheduled volume moves, recomputed rows, chunk)."""
    block, n_vol, rows, chunk = ENSEMBLES[request.param]()
    plain = block()
    block, *_ = ENSEMBLES[request.param]()
    rec = Recorder()
    profiling.attach(rec)
    try:
        traced = block()
    finally:
        profiling.detach()
    return plain, traced, rec, n_vol, rows, chunk


def test_spans_count_volume_moves_recomputes_and_chunks(runs):
    plain, _, rec, n_vol, rows, chunk = runs
    vols = rec.named("volume_move")
    assert len(vols) == n_vol > 0
    assert (plain.att[:, 2] == n_vol).all()
    assert all(rec.spans[i][1:] == (1, True, None) for i in vols)
    recs = rec.named("recompute")
    assert len(recs) == n_vol + 1
    # each volume move's recompute nests in it; the block end's in nothing
    assert [rec.spans[i][3] for i in recs] == vols + [None]
    for i in recs:
        assert rec.spans[i][1:3] == (rows, True)
        chunks = rec.children(i, "chunk")
        assert len(chunks) == math.ceil(rows / chunk)
        assert sum(rec.spans[j][1] for j in chunks) == rows
        assert not any(rec.spans[j][2] for j in chunks)
        for j in chunks:
            assert {rec.spans[k][0] for k, s in enumerate(rec.spans)
                    if s[3] == j} == PHASES
    assert not any(s[2] for s in rec.spans if s[0] in PHASES)
    assert len(rec._open) == 0


def test_states_equal_with_and_without_sink(runs):
    plain, traced, *_ = runs
    for f in dataclasses.fields(plain):
        a, b = getattr(plain, f.name), getattr(traced, f.name)
        if isinstance(a, torch.Tensor):
            assert torch.equal(a, b), f.name


def test_span_without_sink_is_one_shared_nullcontext():
    profiling.detach()
    first = profiling.span("volume_move")
    assert profiling.span("chunk", 8, sync=False) is first
    assert isinstance(first, contextlib.nullcontext)
    code = profiling.span.__code__
    entered, inside = [], []

    def watch(frame, event, arg):
        if event == "call" and frame.f_code is code:
            entered.append(frame.f_code.co_name)
        elif event == "c_call" and frame.f_code is code \
                or event == "call" and frame.f_back is not None \
                and frame.f_back.f_code is code:
            inside.append((event, arg or frame.f_code.co_name))

    sys.setprofile(watch)
    try:
        got = profiling.span("recompute", 1024)
    finally:
        sys.setprofile(None)
    assert got is first
    assert entered == ["span"] and inside == []
