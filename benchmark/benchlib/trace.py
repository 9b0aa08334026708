"""The traced run: ``torch.profiler`` over the whole measured window, reduced
to what the per-layer readers need.

The harness marks the window with a ``bench.window`` range and each request
with ``bench.request``; the program marks the four stages of every PBS with
its ``pbs.*`` scopes.  From the profiler's own event list (no trace file is
written) the reduction takes:

  * every device activity (kernel, copy, set) with its interval;
  * for each, the host time of the runtime call that launched it (matched by
    correlation id), and so the ``pbs.*`` scope open on the host at that time;
  * the union of the device intervals inside the window (``busy_s``) and the
    gaps between them, each labelled by what the host was doing at its
    middle: the innermost ``bench.*`` or ``pbs.*`` scope and the innermost
    operation open there.
"""

from __future__ import annotations

import bisect
import contextlib
import time
from collections import Counter
from dataclasses import dataclass, field

import torch

WINDOW = "bench.window"
REQUEST = "bench.request"
#: the longest names the breakdown keeps
NAME_CHARS = 120


@dataclass
class TraceSummary:
    window_s: float
    busy_s: float
    #: device seconds of the activities each scope launched, by scope name
    device_s_by_scope: dict = field(default_factory=dict)
    #: device seconds by activity name
    device_s_by_name: dict = field(default_factory=dict)
    #: host scopes opened inside the window, by name
    scope_counts: dict = field(default_factory=dict)
    #: idle device seconds by what the host was doing
    idle_s_by_host: dict = field(default_factory=dict)
    #: what taking and reducing the trace cost, in seconds, and its events
    cost_s: dict = field(default_factory=dict)

    def top(self, table: dict, count: int = 10) -> list:
        return [[name, seconds] for name, seconds in
                sorted(table.items(), key=lambda kv: -kv[1])[:count]]


def summed(summaries: list) -> TraceSummary:
    """The cards' summaries of one run as one: every second and count summed
    over the cards, so that ``busy_s / window_s`` is the mean busy share."""
    total = TraceSummary(window_s=sum(s.window_s for s in summaries),
                         busy_s=sum(s.busy_s for s in summaries))
    for name in ("device_s_by_scope", "device_s_by_name", "scope_counts", "idle_s_by_host",
                 "cost_s"):
        table = Counter()
        for s in summaries:
            table.update(getattr(s, name))
        setattr(total, name, dict(table))
    return total


@contextlib.contextmanager
def traced(device: torch.device, before_window=None, after_window=None):
    """Profile the block; yields a list that holds the TraceSummary on exit.
    ``before_window`` and ``after_window`` are called with the profiler on,
    just before the window's range opens and just after it closes."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    out: list[TraceSummary] = []
    with torch.profiler.profile(activities=activities) as prof:
        if before_window is not None:
            before_window()
        with torch.profiler.record_function(WINDOW):
            yield out
        if after_window is not None:
            after_window()
        t = time.perf_counter()
    stop_s = time.perf_counter() - t
    t = time.perf_counter()
    events = prof.profiler.kineto_results.events()
    summary = reduce_events(events)
    summary.cost_s = {"profiler_stop_s": stop_s, "reduce_s": time.perf_counter() - t,
                      "events": len(events)}
    out.append(summary)


def _on_host(event) -> bool:
    return str(event.device_type()).endswith("CPU")


def reduce_events(events) -> TraceSummary:
    host, runtime_start, device = [], {}, []
    for e in events:
        if _on_host(e):
            name = e.name()
            start, end = e.start_ns(), e.end_ns()
            if name.startswith("cuda") or name.startswith("cu"):
                runtime_start[e.correlation_id()] = start
            host.append((start, end, name, e.start_thread_id(), e.is_user_annotation()))
        elif not e.is_user_annotation():
            device.append((e.start_ns(), e.end_ns(), e.name(), e.correlation_id()))
    windows = [h for h in host if h[4] and h[2] == WINDOW]
    if not windows:
        raise RuntimeError(f"the trace holds no {WINDOW!r} range")
    w0, w1, _, thread, _ = windows[0]
    host = sorted((h for h in host if h[3] == thread), key=lambda h: (h[0], -h[1]))
    scopes = [h for h in host if h[4] and h[2].startswith("pbs.") and w0 <= h[0] <= w1]
    scope_starts = [s[0] for s in scopes]

    summary = TraceSummary(window_s=(w1 - w0) / 1e9, busy_s=0.0)
    by_scope, by_name = Counter(), Counter()
    intervals = []
    for start, end, name, corr in device:
        if end <= w0 or start >= w1:
            continue
        start, end = max(start, w0), min(end, w1)
        intervals.append((start, end))
        seconds = (end - start) / 1e9
        by_name[name[:NAME_CHARS]] += seconds
        launched = runtime_start.get(corr)
        i = bisect.bisect_right(scope_starts, launched) - 1 if launched is not None else -1
        if i >= 0 and launched <= scopes[i][1]:
            by_scope[scopes[i][2]] += seconds
        else:
            by_scope["(no pbs scope)"] += seconds
    gaps = _gaps(sorted(intervals), w0, w1)
    summary.busy_s = (w1 - w0) / 1e9 - sum(g1 - g0 for g0, g1 in gaps) / 1e9
    summary.device_s_by_scope = dict(by_scope)
    summary.device_s_by_name = dict(by_name)
    summary.scope_counts = dict(Counter(h[2] for h in host
                                        if h[4] and w0 <= h[0] <= w1 and h[2] != WINDOW))
    summary.idle_s_by_host = _label_gaps(gaps, host)
    return summary


def _gaps(intervals, w0: int, w1: int) -> list[tuple[int, int]]:
    """The stretches of [w0, w1] that no interval covers."""
    gaps, reach = [], w0
    for start, end in intervals:
        if start > reach:
            gaps.append((reach, start))
        reach = max(reach, end)
    if reach < w1:
        gaps.append((reach, w1))
    return gaps


def _label_gaps(gaps, host) -> dict:
    """Idle seconds by what the host was doing at each gap's middle: host
    ranges of one thread nest, so a sweep keeps the stack of open ones."""
    idle = Counter()
    stack, j = [], 0
    for g0, g1 in sorted(gaps, key=lambda g: g[0] + g[1]):
        mid = (g0 + g1) // 2
        while j < len(host) and host[j][0] <= mid:
            while stack and stack[-1][1] < host[j][0]:
                stack.pop()
            stack.append(host[j])
            j += 1
        while stack and stack[-1][1] < mid:
            stack.pop()
        scope = next((h[2] for h in reversed(stack)
                      if h[4] and (h[2].startswith("pbs.") or h[2].startswith("bench."))), "-")
        inner = stack[-1][2] if stack else "-"
        idle[f"{scope} / {inner[:NAME_CHARS]}"] += (g1 - g0) / 1e9
    return dict(idle)
