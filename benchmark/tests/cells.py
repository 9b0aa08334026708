"""Cells of BENCHMARK.json cut to sizes a CPU test can run: the nano and
test_insecure lattices, small batches.  The program runs its kernels' plain
twins on the CPU.

Each cell keeps its own configuration but for the lattice (``SMALL``), and
takes its small traffic from its client's module (``clients/<client>.py``
holds ``SMALL``, the traffic keys it overrides), so a new configuration or
client needs nothing here."""

from __future__ import annotations

import dataclasses
import time

import torch

from benchmark.benchlib import runner, spec

#: the lattices of the tests: the only keys a test changes in a configuration
SMALL = {
    "nano": {"glwe_dimension": 1, "log_degree": 6, "lwe_dimension": 4},
    "test_insecure": {"glwe_dimension": 2, "log_degree": 9, "lwe_dimension": 4},
}


def small_config(name: str, config: str = "default_128") -> dict:
    """``configs/<config>.json`` on the lattice ``name``; its decompositions,
    digits, log_p and noise as they are."""
    base = spec.read_json(spec.BENCH_DIR / "configs" / f"{config}.json")
    return dict(base, **SMALL[name])


def small_cell(cell_name: str, config: str = "nano", impl: str | None = None,
               check_requests: int = 2) -> spec.Cell:
    cell = spec.load_cell(cell_name)
    workload = dict(cell.workload, check_requests=check_requests)
    if impl is not None:
        workload["impl"] = impl
    client = cell.traffic["client"]
    return dataclasses.replace(
        cell, config=small_config(config, cell.config_name), config_name=config,
        traffic=dict(cell.traffic, **spec.load_module("clients", client).SMALL),
        workload=workload)


def run_small(cell: spec.Cell, seed: int = 2**31 + 11, seconds: float = 0.3,
              trace: bool = False, control: bool = False) -> dict:
    return runner.run_cell(cell, seed, seconds, trace, torch.device("cpu"),
                           time.perf_counter(), control=control)
