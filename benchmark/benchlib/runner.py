"""One run of one cell: set-up, the measured window, the check, the metrics.

Set-up (counted in ``setup_s``, from the first line of ``run.py``): the card,
the key material drawn from the seed on the device, the program's server
key (``tfhe_tpu_torch.make_server_key``, the deterministic core of its
keygen), the key form the cell's impl reads (``with_key_form``), the pool of
input ciphertexts the cell's client encrypts, and two warm requests at the
cell's own shapes (the first loads, or on a checkout's first run builds, the
kernels).

The window: the client's requests in a closed loop, one in flight, each
synchronised before the next is issued, until ``seconds`` have passed; the
request that is running then is finished and counted.  Every output is kept.

The check, once the window has closed, the peak memory read and the program's
keys freed: the reference derives its own keys from the same draws and the
client compares (``clients/*.py``).  Its numbers and limits are printed last
on standard error and last in the result line.
"""

from __future__ import annotations

import json
import random
import statistics
import sys
import time
from dataclasses import dataclass

import torch

import tfhe_tpu_torch as tfhe
from benchmark.benchlib import card as bcard
from benchmark.benchlib import guard, spec
from benchmark.benchlib.trace import REQUEST, TraceSummary, traced
from benchmark.reference import tfhe_ref as ref


def log(*parts) -> None:
    print("benchmark:", *parts, file=sys.stderr, flush=True)


@dataclass
class Context:
    """What a client reads: the cell, the device, the seed's generator, the
    configuration and the program's server key."""

    cell: spec.Cell
    device: torch.device
    seed: int
    p: ref.Params
    impl: str
    gen: torch.Generator
    lwe_sk: torch.Tensor
    sk: object = None


@dataclass
class Served:
    request: object
    t_issue: float
    t_done: float
    units: int
    pbs_batches: tuple
    outputs: object = None


@dataclass
class Run:
    """What a metric reader reads."""

    cell: spec.Cell
    p: ref.Params
    card: str
    setup: dict
    served: list
    window_s: float
    trace: TraceSummary | None = None


def program_params(p: ref.Params):
    """The configuration as the program's parameter object."""
    dec = tfhe.DecomposerParams
    return tfhe.TfheParams(
        glwe_dimension=p.glwe_dimension, log_degree=p.log_degree,
        lwe_dimension=p.lwe_dimension, padding_bits=p.padding_bits, log_p=p.log_p,
        log_q=p.log_q, ks_decomposer=dec(p.ks_log_base, p.ks_levels, p.log_q),
        pbs_decomposer=dec(p.pbs_log_base, p.pbs_levels, p.log_q),
        lwe_std_dev=p.lwe_std_dev, glwe_std_dev=p.glwe_std_dev, name=p.name)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _built_libraries() -> int:
    build = spec.ROOT / "build" / "tfhe_tpu_torch"
    return len(list(build.glob("*.so"))) if build.is_dir() else 0


def _generator(device: torch.device, seed: int) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(seed % (1 << 63))


def _tensors(outputs) -> list:
    return [outputs] if isinstance(outputs, torch.Tensor) else list(outputs)


def _reserve_for_outputs(outputs, seconds: float, request_s: float) -> None:
    """Let the allocator hold, before the window, the blocks for every output
    the window keeps (one request's ``outputs`` times the requests that fit
    in ``seconds`` at ``request_s`` each, and a quarter more), so that no
    allocation inside the window has to ask the card for memory."""
    count = int(1.25 * seconds / max(request_s, 1e-3)) + 8
    held = [torch.empty_like(t) for _ in range(count) for t in _tensors(outputs)]
    del held


def _timed(setup: dict, label: str, device: torch.device, fn):
    """``fn()``, with its seconds up to a synchronised card stored as ``setup[label]``."""
    t = time.perf_counter()
    out = fn()
    _sync(device)
    setup[label] = time.perf_counter() - t
    return out


def _set_up(cell, seed: int, seconds: float, device: torch.device, impl: str, setup: dict):
    """The card, the key material, the program's keys, the client's pool and
    two warm requests; returns the context and the client."""
    p = ref.params_from_config(cell.config_name, cell.config)
    if device.type == "cuda":
        _timed(setup, "cuda_init_s", device,
               lambda: (torch.cuda.set_device(device), torch.zeros(1, device=device)))
    gen = _generator(device, seed)
    draws = _timed(setup, "draws_s", device, lambda: ref.draw_keys(p, gen))
    carried = [ref.to_carrier(x) for x in (draws.lwe_sk, draws.glwe_sk, draws.bk_a, draws.bk_e,
                                           draws.ksk_a, draws.ksk_e)]
    ctx = Context(cell=cell, device=device, seed=seed, p=p, impl=impl, gen=gen,
                  lwe_sk=draws.lwe_sk)
    del draws  # the check draws them again from the seed
    sk = _timed(setup, "keygen_s", device,
                lambda: tfhe.make_server_key(program_params(p), *carried))
    del carried
    ctx.sk = _timed(setup, "keyform_s", device, lambda: tfhe.with_key_form(sk, impl))
    del sk
    client = _timed(setup, "pool_s", device,
                    lambda: spec.client_class(cell.traffic["client"])(ctx))
    libraries = _built_libraries()
    for label in ("warm1_s", "warm2_s"):
        outputs = _timed(setup, label, device, lambda: client.serve(client.warm_request()))
    setup["built_libraries"] = _built_libraries() - libraries
    _timed(setup, "reserve_s", device,
           lambda: _reserve_for_outputs(outputs, seconds, setup["warm2_s"]))
    return ctx, client


def _measure(client, seconds: float, trace: bool, device: torch.device, sampler):
    """The window, traced or not; returns the served requests, the window's
    seconds, the trace summary (or None) and the SM clocks ``sampler`` took."""
    if sampler:
        sampler.open()
    served: list[Served] = []
    summary = None
    if trace:
        with traced(device) as out:
            window_s = _window(client, served, seconds, device, traced_requests=True)
        summary = out[0]
    else:
        window_s = _window(client, served, seconds, device, traced_requests=False)
    clocks = []
    if sampler:
        sampler.close()
        clocks = sampler.stop()
    return served, window_s, summary, clocks


def run_cell(cell: spec.Cell, seed: int, seconds: float, trace: bool, device: torch.device,
             t_start: float, control: bool = False, marks: dict | None = None) -> dict:
    """Run ``cell`` once; return the result line as a dict ("checks" last).
    ``marks`` holds the seconds run.py spent before the call, by part."""
    setup = dict(marks or {})
    setup["before_run_s"] = time.perf_counter() - t_start
    impl = cell.workload["control_impl"] if control else cell.workload["impl"]
    on_card = device.type == "cuda"
    kind = torch.cuda.get_device_name(device) if on_card else "cpu"
    log(f"cell {cell.name}: config {cell.config_name}, traffic {cell.traffic_name}, impl {impl}"
        f"{' (control)' if control else ''}, seed {seed}, {seconds} s, trace {int(trace)}")
    power_limit, sampler = None, None
    if on_card:
        name, power_limit = bcard.name_and_power_limit(device.index or 0)
        log(f"card: {name}, power limit {power_limit}")
        sampler = bcard.ClockSampler(device.index or 0)
        sampler.start()

    ctx, client = _set_up(cell, seed, seconds, device, impl, setup)
    setup["setup_s"] = time.perf_counter() - t_start
    log("set-up: " + ", ".join(f"{k} {v:.3f}" for k, v in setup.items()))

    served, window_s, summary, clocks = _measure(client, seconds, trace, device, sampler)
    memory_peak = torch.cuda.max_memory_allocated(device) if on_card else 0
    guard.check_imports("after the window")
    latency = sorted((s.t_done - s.t_issue) * 1e3 for s in served)
    latency_ms = {f"p{q}": latency[min(len(latency) - 1, len(latency) * q // 100)]
                  for q in (0, 50, 90, 95, 99)} | {"max": latency[-1]}
    log(f"window: {len(served)} requests in {window_s:.3f} s; latency ms "
        + json.dumps(latency_ms) + "; SM clock "
        + (f"{min(clocks):.0f}-{statistics.median(clocks):.0f}-{max(clocks):.0f} MHz over "
           f"{len(clocks)} samples" if clocks else "not sampled"))

    run = Run(cell=cell, p=ctx.p, card=kind, setup=setup, served=served, window_s=window_s,
              trace=summary)
    metrics = {}
    for entry in cell.per_layer if trace else cell.end_to_end:
        value = spec.metric_reader(entry["name"])(run)
        if value is not None:
            metrics[entry["name"]] = {"value": value, "unit": entry["unit"]}

    # the check: the program's keys go first, then the reference works
    ctx.sk = None
    client.release_program_state()
    if on_card:
        torch.cuda.empty_cache()
    t = time.perf_counter()
    keys = ref.derive_keys(ctx.p, ref.draw_keys(ctx.p, _generator(device, seed)))
    numbers, info, failed = client.check(keys, served, random.Random(seed ^ 0x5EED))
    _sync(device)
    info["check_s"] = time.perf_counter() - t
    correct = all(value <= limit for value, limit in numbers.values())

    result = {"correct": correct, "attempted": len(served), "failed": failed,
              "metrics": metrics,
              "device": {"platform": "gpu" if on_card else "cpu", "kind": kind, "count": 1,
                         "memory_peak_bytes": memory_peak}}
    if summary is not None:
        result["device"]["busy_s"] = summary.busy_s
        result["device"]["window_s"] = summary.window_s
        result["breakdown"] = {"device_ops": summary.top(summary.device_s_by_name),
                               "idle_gaps": summary.top(summary.idle_s_by_host)}
        result["trace_cost"] = summary.cost_s
        log("device seconds by scope: " + json.dumps(summary.device_s_by_scope))
        log("trace cost: " + json.dumps(summary.cost_s))
    result["window"] = {"seconds": window_s, "latency_ms": latency_ms}
    result["card"] = {"power_limit": power_limit, "sm_clock_samples": len(clocks),
                      "sm_clock_mhz": [min(clocks), statistics.median(clocks), max(clocks)]
                      if clocks else None}
    result["setup"] = setup
    result["check_info"] = info
    result["checks"] = {name: {"value": value, "limit": limit}
                        for name, (value, limit) in numbers.items()}
    log("check info: " + json.dumps(info))
    log(f"correct: {str(correct).lower()}; the numbers compared, each with its limit:")
    for name, (value, limit) in numbers.items():
        log(f"check {name}: {value} (limit {limit})")
    return result


def _window(client, served: list, seconds: float, device: torch.device,
            traced_requests: bool) -> float:
    """The closed loop: requests one at a time until ``seconds`` have passed;
    returns the seconds from the first issue to the last completion."""
    record = torch.profiler.record_function
    i = 0
    t_open = time.perf_counter()
    deadline = t_open + seconds
    while True:
        request = client.request(i)
        t_issue = time.perf_counter()
        if traced_requests:
            with record(REQUEST):
                outputs = client.serve(request)
                _sync(device)
        else:
            outputs = client.serve(request)
            _sync(device)
        t_done = time.perf_counter()
        served.append(Served(request, t_issue, t_done, client.units(request),
                             tuple(client.pbs_batches(request)), outputs))
        i += 1
        if t_done >= deadline:
            return t_done - t_open


def print_result(result: dict) -> None:
    print(json.dumps(result), flush=True)

