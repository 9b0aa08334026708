#!/usr/bin/env python3
"""What the program's profiling scopes cost on the card.

    python3 scripts/scope_overhead.py        # one CUDA card, ~1 min

``utils/profiling.py:scope`` opens a ``torch.profiler.record_function``
range and records a span only while a torch profiler runs; with none
running it returns a shared no-op after one flag check.  This script times
that against scopes that always open their range:

  * one empty ``scope`` enter and exit on the host: as shipped with no
    profiler running, as shipped while ``torch.profiler.profile`` (CPU and
    CUDA) runs, and a bare ``record_function`` with no profiler;
  * at default_128, the 'fusedl' NAND gate at B=1 (the small-batch path,
    where the host's work shows) and the 'fusedp' NAND gate at B=1024, with
    the scopes as shipped ("shipped") and as ranges that are always open
    ("always": the four PBS stages in bare ``record_function`` ranges, no
    gate scopes), in turns (always, shipped, shipped, always), with no
    profiler running.  Each turn is the mean of CALLS gates back to back
    after a warm-up, timed with CUDA events while nvidia-smi samples the SM
    clock (``utils/profiling.py:sampled_clocks``);
  * the host milliseconds of one such gate as shipped, the card drained
    before each call, with no profiler and with one running (``_host_ms``).

It prints one JSON line (every number unrounded) and writes
``chiprun_out/scope_overhead.json``.  It imports neither JAX nor ``tfhe_tpu``.
"""

from __future__ import annotations

import contextlib
import json
import statistics
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
OUT = ROOT / "chiprun_out" / "scope_overhead.json"
#: impl -> (batch, gates per turn)
GATES = {"fusedl": (1, 30), "fusedp": (1024, 5)}
TURNS = ("always", "shipped", "shipped", "always")
EMPTY_SCOPES = 100_000
#: fewer while a profiler runs: each span is kept, and the profiler keeps its range
EMPTY_SCOPES_PROFILED = 20_000


def _empty_us(scope, count: int) -> float:
    t0 = time.perf_counter()
    for _ in range(count):
        with scope("pbs.empty"):
            pass
    return (time.perf_counter() - t0) / count * 1e6


def _record_function(name, **attrs):
    return torch.profiler.record_function(name)


def _host_ms(gate, calls: int) -> dict:
    """The host milliseconds of one ``gate()`` call, from its start to its
    return, the card drained before each: the median over ``calls`` with no
    profiler running, and the mean of the recorded ``pbs.gate`` spans less
    their card waits while ``torch.profiler.profile`` runs (what the
    benchmark's ``pbs.host_ms_per_gate`` reads)."""
    from tfhe_tpu_torch.utils import profiling

    plain = []
    for _ in range(calls):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        gate()
        plain.append((time.perf_counter() - t0) * 1e3)
    torch.cuda.synchronize()
    activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    profiling.reset()
    with torch.profiler.profile(activities=activities):
        for _ in range(calls):
            torch.cuda.synchronize()
            gate()
        torch.cuda.synchronize()
    spans = [s for s in profiling.spans() if s.name == "pbs.gate"]
    traced = [(s.end_ns - s.start_ns) / 1e6 - s.wait_s * 1e3 for s in spans]
    return {"untraced_median": statistics.median(plain),
            "traced_mean": statistics.fmean(traced) if traced else None,
            "traced_wait_ms_mean": statistics.fmean(s.wait_s * 1e3 for s in spans)
            if spans else None}


def _no_scope(name, **attrs):
    return contextlib.nullcontext()


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("scope_overhead: needs a CUDA card")
    sys.path.insert(0, str(ROOT))
    import tfhe_tpu_torch as tfhe
    from tfhe_tpu_torch.models import boolean as mbool
    from tfhe_tpu_torch.models import bootstrap as mboot
    from tfhe_tpu_torch.utils import profiling
    from tfhe_tpu_torch.utils.profiling import card_name_and_power_limit, sampled_clocks, scope

    card = card_name_and_power_limit()
    params = tfhe.get_params("default_128")
    ck, sk = tfhe.keygen(params, 0)
    sk = tfhe.with_latency_key(sk)
    rng = np.random.default_rng(3)
    bits = [rng.integers(0, 2, size=1024, dtype=np.uint32) for _ in range(2)]
    ca, cb = (tfhe.encrypt(ck, b, seed) for b, seed in zip(bits, (1, 2)))

    empty = {"shipped_no_profiler_us": _empty_us(scope, EMPTY_SCOPES),
             "record_function_no_profiler_us": _empty_us(_record_function, EMPTY_SCOPES)}
    activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    profiling.reset()
    with torch.profiler.profile(activities=activities):
        empty["shipped_profiled_us"] = _empty_us(scope, EMPTY_SCOPES_PROFILED)
    empty["spans_recorded"] = len(profiling.spans())
    print(f"empty scope: {empty}", file=sys.stderr, flush=True)

    turns = {impl: [] for impl in GATES}
    try:
        for turn in TURNS:
            mboot.scope = scope if turn == "shipped" else _record_function
            mbool.scope = scope if turn == "shipped" else _no_scope
            for impl, (b, calls) in GATES.items():
                ms, clocked = sampled_clocks(
                    lambda: tfhe.gates.nand(sk, ca[:b], cb[:b], impl=impl), calls)
                mhz = sorted(c for c, _ in clocked)
                turns[impl].append({"scopes": turn, "ms": ms, "calls": calls,
                                    "sm_mhz": [mhz[0], mhz[-1]] if mhz else None})
                print(f"{impl} B={b} scopes {turn}: {ms} ms (mean of {calls}); SM clock "
                      f"{mhz[:1] + mhz[-1:]} MHz", file=sys.stderr, flush=True)
    finally:
        mboot.scope = mbool.scope = scope
    host = {impl: _host_ms(lambda: tfhe.gates.nand(sk, ca[:b], cb[:b], impl=impl), calls)
            for impl, (b, calls) in GATES.items()}
    print(f"host ms of one gate, the card drained before it: {host}", file=sys.stderr, flush=True)
    result = {"card": card[0], "power_limit": card[1], "empty_scope": empty,
              "gates": {impl: {"batch": GATES[impl][0], "turns": t, "host_ms": host[impl]}
                        for impl, t in turns.items()}}
    OUT.parent.mkdir(exist_ok=True)
    OUT.write_text(json.dumps(result, indent=1))
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
