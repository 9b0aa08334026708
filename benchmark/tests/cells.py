"""Cells of BENCHMARK.json cut to sizes a CPU test can run: the nano and
test_insecure lattices, small batches.  The program runs its kernels' plain
twins on the CPU."""

from __future__ import annotations

import dataclasses
import time

import torch

from benchmark.benchlib import runner, spec

#: parameter sets for the tests, as configuration files state them
SMALL = {
    "nano": {"glwe_dimension": 1, "log_degree": 6, "lwe_dimension": 4},
    "test_insecure": {"glwe_dimension": 2, "log_degree": 9, "lwe_dimension": 4},
}

#: each cell's traffic cut down: a few ciphertexts a request, a small pool
SMALL_TRAFFIC = {
    "gate_batch": {"batch": 4, "pool": 2},
    "gate_batch_dp": {"batch": 8, "pool": 2},
    "ripple_add": {"width": 4, "batch": 2, "pool": 3},
}


def small_config(name: str) -> dict:
    base = spec.read_json(spec.BENCH_DIR / "configs" / "default_128.json")
    return dict(base, **SMALL[name])


def small_cell(cell_name: str, config: str = "nano", impl: str | None = None,
               check_requests: int = 2) -> spec.Cell:
    cell = spec.load_cell(cell_name)
    workload = dict(cell.workload, check_requests=check_requests)
    if impl is not None:
        workload["impl"] = impl
    return dataclasses.replace(
        cell, config=small_config(config), config_name=config,
        traffic=dict(cell.traffic, **SMALL_TRAFFIC[cell.traffic["client"]]),
        workload=workload)


def run_small(cell: spec.Cell, seed: int = 2**31 + 11, seconds: float = 0.3,
              trace: bool = False, control: bool = False) -> dict:
    return runner.run_cell(cell, seed, seconds, trace, torch.device("cpu"),
                           time.perf_counter(), control=control)
