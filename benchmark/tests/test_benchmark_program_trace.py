"""The readers of the program's own spans and counters, on traced runs of
each cell at nano on the CPU: every metric they add is in the result line,
and the ciphertexts the program counted are those the client sent."""

from __future__ import annotations

from types import SimpleNamespace

import pytest

from benchmark.benchlib import spec
from benchmark.tests.cells import run_small, small_cell

BENCH = spec.benchmark_json()
#: the metrics read from the program's spans and counters, by the cell they apply to
PROGRAM_METRICS = {
    "d128.add8.b1": ["pbs.card_waits_per_add", "pbs.ciphertexts_per_add",
                     "pbs.host_ms_per_gate.add", "pbs.gate_idle_pct.add",
                     "circuits.host_ms_outside_gates_per_add"],
    "d128.gates.b1024": ["pbs.host_ms_per_gate.gates"],
    "d128.gates.b64.nttf": ["pbs.host_ms_per_gate.nttf"],
}


@pytest.mark.parametrize("cell", sorted(PROGRAM_METRICS))
def test_a_traced_run_reports_the_program_metrics(cell):
    small = small_cell(cell)
    result = run_small(small, trace=True)
    assert result["correct"] is True
    metrics = result["metrics"]
    for name in PROGRAM_METRICS[cell]:
        assert name in metrics, name
        assert metrics[name]["value"] >= 0
    if cell == "d128.add8.b1":
        traffic = small.traffic
        batches = spec.client_class(traffic["client"]).pbs_batches(
            SimpleNamespace(width=traffic["width"], batch=traffic["batch"]), 0)
        assert metrics["pbs.ciphertexts_per_add"]["value"] == sum(batches)
        assert metrics["pbs.card_waits_per_add"]["value"] == 0  # nothing crosses to a card
        assert metrics["circuits.pbs_calls_per_add"]["value"] == len(batches)


@pytest.mark.parametrize("cell", sorted(PROGRAM_METRICS))
def test_an_untraced_run_reads_none_of_them(cell):
    result = run_small(small_cell(cell), trace=False)
    assert not set(PROGRAM_METRICS[cell]) & set(result["metrics"])


def test_the_metrics_are_declared_for_their_cells():
    per_layer = {m["name"]: m for m in BENCH["per_layer"]}
    for cell, names in PROGRAM_METRICS.items():
        for name in names:
            assert per_layer[name]["workloads"] == [cell]
            same_layer = ("circuits.pbs_calls_per_add" if name.startswith("circuits.")
                          else "pbs.outside_rotation_pct.gates")
            assert per_layer[name]["layer"] == per_layer[same_layer]["layer"]
