"""Profiling hooks (port of ``tfhe_tpu/utils/profiling.py``).

Wrappers over ``torch.profiler``: named scopes around the hot stages, the
program's own span and counter recorder behind them, a one-shot trace
capture that writes a Chrome trace, a stage timer that synchronises the
card, and the measurement helpers the benches share: best-of-rounds timing
with CUDA events, and the card's SM clock and power sampled by
``nvidia-smi`` (a copy of ``scripts/measure_torch.py:sampled_clocks``).

The recorder.  ``scope(name, **attrs)`` does nothing unless a torch profiler
is running: it returns one shared no-op context after a single flag check,
and ``count`` and ``card_wait`` return at once.  While a profiler runs,
``scope`` opens a ``torch.profiler.record_function`` range of that name (so
the span is in the profiler's trace) and keeps a ``Span`` in memory: its
name, start and end, its id, its parent (the span open when it began), its
request (the id of its root span) and its attributes.  Start and end are
``time.time_ns()``, the Unix-epoch clock the profiler stamps host events
with, so spans line up with the trace's kernels.  ``count(name, n)`` adds to
a named counter; ``card_wait(prefix)`` wraps a host call that blocks on the
card, counts it under ``<prefix>.card_waits`` and adds its seconds to every
open span's ``wait_s``.  ``spans()``, ``counters()`` and ``reset()`` read
and clear the store.

The store holds one profiled stretch.  A caller starts one with ``reset()``;
for a caller that cannot (the benchmark harness runs untraced requests and
then a traced window, and reads the store after it), the first record made
after a ``scope`` ran with no profiler also clears the spans and counters
(the ``_stale`` flag), so each traced window of a process reads only its
own.  At most ``MAX_SPANS`` spans are kept; the rest are counted under
``spans_dropped``.
"""

from __future__ import annotations

import contextlib
import itertools
import os
import subprocess
import threading
import time
from collections import defaultdict
from datetime import datetime

import torch
import torch.autograd.profiler as _autograd_profiler

#: the most spans the store keeps in one profiled stretch
MAX_SPANS = 1 << 20
#: the counter of spans left out of a full store
SPANS_DROPPED = "spans_dropped"


#: the shared context ``scope`` and ``card_wait`` return when no profiler runs
NO_SCOPE = contextlib.nullcontext()


class Span:
    """One recorded scope: ``start_ns``/``end_ns`` on ``time.time_ns()``'s
    clock (``end_ns`` is None while it is open), ``id``, ``parent`` (None for
    a root), ``request`` (its root's id), ``attrs``, and the seconds of the
    card waits inside it (``wait_s``)."""

    __slots__ = ("name", "attrs", "id", "parent", "request", "start_ns", "end_ns", "wait_s",
                 "_range")

    def __init__(self, name: str, attrs: dict):
        self.name = name
        self.attrs = attrs
        self.end_ns = None
        self.wait_s = 0.0

    def __enter__(self):
        _fresh_window()
        stack = _open_spans()
        parent = stack[-1] if stack else None
        self.id = next(_ids)
        self.parent = parent.id if parent is not None else None
        self.request = parent.request if parent is not None else self.id
        if len(_spans) < MAX_SPANS:
            _spans.append(self)
        else:
            _counters[SPANS_DROPPED] += 1
        self._range = torch.profiler.record_function(self.name)
        self._range.__enter__()
        stack.append(self)
        self.start_ns = time.time_ns()
        return self

    def __exit__(self, *exc):
        self.end_ns = time.time_ns()
        _open_spans().pop()
        self._range.__exit__(*exc)
        self._range = None
        return False


_spans: list[Span] = []
_counters: defaultdict = defaultdict(int)
_ids = itertools.count(1)
_local = threading.local()
#: set by a ``scope`` that ran with no profiler: the next record starts afresh
_stale = False


def _open_spans() -> list:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


def _fresh_window() -> None:
    global _stale
    if _stale:
        _stale = False
        reset()


def scope(name: str, **attrs):
    """Named scope: with a profiler running, a ``record_function`` range of
    ``name`` and a recorded ``Span`` with ``attrs``; otherwise the shared
    no-op ``NO_SCOPE``."""
    if not _autograd_profiler._is_profiler_enabled:
        global _stale
        _stale = True
        return NO_SCOPE
    return Span(name, attrs)


def count(name: str, n=1) -> None:
    """Add ``n`` to the counter ``name`` (only while a profiler runs)."""
    if _autograd_profiler._is_profiler_enabled:
        _fresh_window()
        _counters[name] += n


@contextlib.contextmanager
def _timed_wait(prefix: str):
    _fresh_window()
    t0 = time.perf_counter()
    try:
        yield
    finally:
        seconds = time.perf_counter() - t0
        _counters[prefix + ".card_waits"] += 1
        for span in _open_spans():
            span.wait_s += seconds


def card_wait(prefix: str):
    """Context around a host call that blocks until the card has drained:
    while a profiler runs, it counts the call under ``<prefix>.card_waits``
    and adds its seconds to each open span's ``wait_s``."""
    if not _autograd_profiler._is_profiler_enabled:
        return NO_SCOPE
    return _timed_wait(prefix)


def spans() -> list[Span]:
    """The spans of the newest profiled stretch, in the order they began."""
    return list(_spans)


def counters() -> dict:
    """The counters of the newest profiled stretch."""
    return dict(_counters)


def reset() -> None:
    """Clear the spans and the counters."""
    _spans.clear()
    _counters.clear()


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
