"""Profiling hooks (port of ``tfhe_tpu/utils/profiling.py``).

Thin wrappers over ``torch.profiler``: named scopes around the hot stages
(the four stages of ``models/bootstrap.py:pbs``), a one-shot trace capture
that writes a Chrome trace, a stage timer that synchronises the card, and
the measurement helpers the benches share: best-of-rounds timing with CUDA
events, and the card's SM clock and power sampled by ``nvidia-smi``
(a copy of ``scripts/measure_torch.py:sampled_clocks``).
"""

from __future__ import annotations

import contextlib
import os
import subprocess
import time
from datetime import datetime

import torch


def scope(name: str):
    """Named scope: a ``torch.profiler.record_function`` range, so the stage
    shows up by name in a captured trace (used around the PBS stages in
    models/bootstrap.py)."""
    return torch.profiler.record_function(name)


@contextlib.contextmanager
def capture_trace(log_dir: str):
    """Capture a trace around a block and write it into ``log_dir`` as a
    Chrome trace (``trace_<pid>_<ns>.json``).  It records CPU activity, and
    the card's kernels as well when a card is present."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(
        os.path.join(log_dir, f"trace_{os.getpid()}_{time.time_ns()}.json"))


def synchronize(*tensors) -> None:
    """Wait for the card that holds each CUDA tensor given (CPU tensors are
    done when their call returns)."""
    for t in tensors:
        if t.device.type == "cuda":
            torch.cuda.synchronize(t.device)


class Timer:
    """Wall-clock stage timer with a device sync at each mark."""

    def __init__(self):
        self.marks: list[tuple[str, float]] = []
        self._t = time.perf_counter()

    def mark(self, name: str, *block_on) -> float:
        """Record the seconds since the last mark, once the card of each
        tensor in ``block_on`` is done; return them."""
        synchronize(*block_on)
        now = time.perf_counter()
        self.marks.append((name, now - self._t))
        self._t = now
        return self.marks[-1][1]

    def __str__(self):
        return ", ".join(f"{n}: {dt*1e3:.1f}ms" for n, dt in self.marks)


def time_best(fn, iters: int, device, rounds: int = 3):
    """Best seconds per call of ``fn()``: one warm-up call, then ``rounds``
    rounds of ``iters`` calls back to back with one sync at the end of each.
    On the card the rounds are timed with CUDA events, on the CPU with the
    host clock.  Returns the seconds and the last call's output."""
    on_card = torch.device(device).type == "cuda"
    out = fn()
    if on_card:
        torch.cuda.synchronize(device)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
    best = float("inf")
    for _ in range(rounds):
        if on_card:
            start.record()
            for _ in range(iters):
                out = fn()
            end.record()
            end.synchronize()
            seconds = start.elapsed_time(end) / 1e3
        else:
            t0 = time.perf_counter()
            for _ in range(iters):
                out = fn()
            seconds = time.perf_counter() - t0
        best = min(best, seconds / iters)
    return best, out


def card_name_and_power_limit() -> tuple[str, str]:
    """The current card's name and power limit, as ``nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader`` gives them."""
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader",
         "-i", str(torch.cuda.current_device())],
        capture_output=True, text=True, timeout=60, check=True)
    name, limit = (part.strip() for part in smi.stdout.strip().split(","))
    return name, limit


@contextlib.contextmanager
def clock_samples():
    """Sample the current card's SM clock (MHz) and power draw (W) with
    ``nvidia-smi`` every 100 ms while the block runs.  The yielded list is
    filled on exit with the samples whose timestamps fall inside the block;
    the block synchronises the card before it ends."""
    smi = subprocess.Popen(
        ["nvidia-smi", "--query-gpu=timestamp,clocks.sm,power.draw",
         "--format=csv,noheader,nounits", "-i", str(torch.cuda.current_device()),
         "-lms", "100"],
        stdout=subprocess.PIPE, text=True)
    samples: list[tuple[float, float]] = []
    try:
        time.sleep(1.0)  # let the sampler start before the window opens
        t0 = datetime.now()
        yield samples
        t1 = datetime.now()
        time.sleep(0.3)
    finally:
        smi.terminate()
        text, _ = smi.communicate(timeout=30)
    for line in text.splitlines():
        parts = [p.strip() for p in line.split(",")]
        if len(parts) != 3:
            continue
        stamp = datetime.strptime(parts[0], "%Y/%m/%d %H:%M:%S.%f")
        if t0 <= stamp <= t1:
            samples.append((float(parts[1]), float(parts[2])))


def sampled_clocks(fn, calls: int, warmup: bool = True,
                   before=None) -> tuple[float, list[tuple[float, float]]]:
    """Run ``fn()`` ``calls`` times back to back between CUDA events while
    ``nvidia-smi`` samples the SM clock (MHz) and power draw (W) every 100
    ms: after one warm-up call unless ``warmup`` is false, and after
    ``before()`` (a barrier of the ranks, say) once the sampler runs.  Return
    the mean device ms per call and the samples whose timestamps fall inside
    the window, which opens before ``before()`` and closes when the last call
    has finished."""
    if warmup:
        fn()
        torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    with clock_samples() as samples:
        if before is not None:
            before()
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        end.synchronize()
    return start.elapsed_time(end) / calls, samples
