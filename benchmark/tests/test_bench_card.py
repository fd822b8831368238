"""On the card (skipped without one): one short run of each cell through
the harness, as the benchmark runs it, comes out correct and names the
card."""

import time

import pytest
import torch

from benchmark import harness, spec
from benchmark.tests.tiny import CELLS


@pytest.mark.card
@pytest.mark.parametrize("workload", CELLS)
def test_short_run_on_the_card(card, workload):
    rec = harness.run_cell(workload, 2 ** 31 + 5, 1.0, 0, card,
                           time.perf_counter())
    assert rec["correct"], rec["checked"]
    assert rec["device"]["kind"] == torch.cuda.get_device_name(card)
    bench = spec.benchmark()
    assert set(rec["metrics"]) == {m["name"] for m in
                                   spec.end_to_end(bench, workload)}
