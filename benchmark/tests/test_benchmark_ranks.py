"""A cell on four cards, driven on the CPU at nano over four gloo ranks: its
result counts every card, a fault planted on rank 3 alone is caught by the
check on rank 0, and a rank that dies ends the run with no result.  Also:
the one-card cells' result lines keep exactly the keys they had."""

from __future__ import annotations

import subprocess
import sys

import pytest
import torch

from benchmark.benchlib import ranks, spec
from benchmark.tests.cells import run_small, small_cell

DP_CELLS = [w["name"] for w in spec.benchmark_json()["workloads"] if w["chips"] > 1]
ONE_CARD_CELLS = [w["name"] for w in spec.benchmark_json()["workloads"] if w["chips"] == 1]

#: the keys of a one-card result line, as the harness wrote them before cells
#: on several cards (on the CPU, so without run.py's marks and ``cuda_init_s``)
ONE_CARD_KEYS = {
    False: ["correct", "attempted", "failed", "metrics", "device", "window", "card", "setup",
            "check_info", "checks"],
    True: ["correct", "attempted", "failed", "metrics", "device", "breakdown", "trace_cost",
           "window", "card", "setup", "check_info", "checks"],
}
ONE_CARD_DEVICE_KEYS = {False: ["platform", "kind", "count", "memory_peak_bytes"],
                        True: ["platform", "kind", "count", "memory_peak_bytes", "busy_s",
                               "window_s"]}
ONE_CARD_SETUP_KEYS = ["before_run_s", "draws_s", "keygen_s", "keyform_s", "pool_s", "warm1_s",
                       "warm2_s", "built_libraries", "reserve_s", "setup_s"]


@pytest.mark.parametrize("cell", ONE_CARD_CELLS)
@pytest.mark.parametrize("trace", [False, True])
def test_a_one_card_result_keeps_its_keys(cell, trace):
    result = run_small(small_cell(cell), trace=trace)
    assert list(result) == ONE_CARD_KEYS[trace]
    assert list(result["device"]) == ONE_CARD_DEVICE_KEYS[trace]
    assert list(result["setup"]) == ONE_CARD_SETUP_KEYS
    assert list(result["card"]) == ["power_limit", "sm_clock_samples", "sm_clock_mhz"]
    assert result["device"]["count"] == 1


@pytest.mark.parametrize("cell", DP_CELLS)
def test_a_traced_run_counts_every_card(cell):
    small = small_cell(cell)
    result = run_small(small, trace=True)
    assert result["correct"] is True
    device = result["device"]
    assert device["count"] == small.chips == len(device["cards"])
    assert [c["index"] for c in device["cards"]] == list(range(small.chips))
    assert device["memory_peak_bytes"] == max(c["memory_peak_bytes"] for c in device["cards"])
    assert device["window_s"] == pytest.approx(
        sum(c["window_s"] for c in device["cards"]) / small.chips)
    assert {"spawn_s", "join_s", "replicate_s"} <= set(result["setup"])
    assert len(result["setup"]["ranks"]) == small.chips - 1
    assert result["checks"]["diff_words"]["value"] == 0
    info = result["check_info"]  # every rank's rows of each request checked are compared
    assert info["checked_requests"] >= 1
    assert info["checked_words"] == info["checked_requests"] * small.traffic["batch"] * (
        small.config["lwe_dimension"] + 1)


#: code run in rank 3 alone before it starts: each plants a fault in its rows
RANK3_FAULTS = {
    # its rows left as they came in: the gate returns its share of ct0
    "rows_left_as_inputs": (
        "from tfhe_tpu_torch.models import boolean\n"
        "boolean.gate = lambda sk, name, ct0, ct1, impl='auto': ct0.clone()\n"),
    # a wrong key form: the lowest bit of every bootstrapping-key word flipped
    "wrong_key_form": (
        "import dataclasses, tfhe_tpu_torch\n"
        "form = tfhe_tpu_torch.with_key_form\n"
        "tfhe_tpu_torch.with_key_form = lambda sk, impl: dataclasses.replace(\n"
        "    form(sk, impl), bk_u32=sk.bk_u32 ^ 1, bk_lm=sk.bk_lm ^ 1)\n"),
}


def _planted_argv(plant: str, on_rank: int = 3):
    default = ranks.rank_argv

    def argv(rank, world, port, device_type):
        cmd = default(rank, world, port, device_type)
        if rank != on_rank:
            return cmd
        code = (plant + "import runpy, sys\nsys.argv[0] = 'ranks'\n"
                "runpy.run_module('benchmark.benchlib.ranks', run_name='__main__')\n")
        return [sys.executable, "-c", code] + cmd[3:]
    return argv


@pytest.mark.parametrize("cell", DP_CELLS)
@pytest.mark.parametrize("fault", sorted(RANK3_FAULTS))
def test_a_fault_on_one_rank_is_not_correct(cell, fault, monkeypatch):
    monkeypatch.setattr(ranks, "rank_argv", _planted_argv(RANK3_FAULTS[fault]))
    result = run_small(small_cell(cell))
    assert result["correct"] is False
    assert result["checks"]["diff_words"]["value"] > 0
    assert result["failed"] >= 1


#: run.py's main on the CPU at nano, as in test_benchmark_run.py, with rank 3
#: ending itself with status 9 as its window opens
_DEAD_RANK = """
import os, sys
import torch
sys.path.insert(0, '.')
from benchmark.benchlib import ranks, runner
from benchmark.tests import cells
from benchmark.tests.test_benchmark_ranks import _planted_argv
is_available, device_count = torch.cuda.is_available, torch.cuda.device_count
torch.cuda.is_available, torch.cuda.device_count = (lambda: True), (lambda: {chips})
run_cell = runner.run_cell

def small_run(cell, seed, seconds, trace, device, t_start, control=False, marks=None,
              group=None):
    torch.cuda.is_available, torch.cuda.device_count = is_available, device_count
    return run_cell(cells.small_cell(cell.name), seed, seconds, trace, torch.device('cpu'),
                    t_start, control=control, marks=marks, group=group)

runner.run_cell = small_run
start = ranks.Ranks.start
ranks.Ranks.start = classmethod(lambda cls, world, device_type: start(world, 'cpu'))
ranks.rank_argv = _planted_argv(
    "import os\\nfrom benchmark.benchlib import runner\\n"
    "runner._rank_window = lambda *args: os._exit(9)\\n")
sys.argv = ['run.py', '--workload', {cell!r}, '--seed', '5', '--seconds', '30', '--trace', '0']
import runpy
runpy.run_path('benchmark/run.py', run_name='__main__')
"""


@pytest.mark.parametrize("cell", DP_CELLS)
def test_a_dead_rank_ends_the_run_with_no_result(cell):
    chips = spec.load_cell(cell).chips
    proc = subprocess.run([sys.executable, "-c", _DEAD_RANK.format(chips=chips, cell=cell)],
                          cwd=spec.ROOT, capture_output=True, text=True, timeout=120)
    assert proc.returncode == ranks.RANK_FAILED, proc.stderr[-3000:]
    assert proc.stdout == ""
    assert "rank 3 ended with status 9" in proc.stderr
    assert "window:" not in proc.stderr  # it ended inside the window, not after it


@pytest.mark.parametrize("cell", DP_CELLS)
def test_a_cell_on_several_cards_refuses_to_run_without_them(cell):
    if torch.cuda.is_available():
        pytest.skip("a card is present: this checks the refusal without one")
    cmd = spec.benchmark_json()["command"]
    proc = subprocess.run(cmd + ["--workload", cell, "--seed", str(2**31 + 3), "--seconds", "1",
                                 "--trace", "0"],
                          cwd=spec.ROOT, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 2
    assert proc.stdout == ""
    assert f"needs {spec.load_cell(cell).chips} CUDA card(s)" in proc.stderr
