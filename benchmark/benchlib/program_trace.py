"""Arithmetic the readers of the program's own spans and counters share
(``metrics/pbs.*.py``, ``metrics/circuits.host_ms_outside_gates_per_add.py``).

A traced window runs under a torch profiler, and while one runs the program
records spans and counters (``tfhe_tpu_torch.utils.profiling``: ``spans()``,
``counters()``), which hold that window alone when the readers run, in the
same process, after it.  Each function returns None on an untraced run and
where the program records no such span or counter.

The host milliseconds these readers give are traced host time: the profiler
that makes the spans exist adds its own cost to every operation the host
issues inside them, so they read above the same work untraced, and a change
that removes operations shows a larger drop here than untraced.  The
untraced figure comes from ``scripts/scope_overhead.py``.
"""

from __future__ import annotations

import statistics
from collections import defaultdict

from tfhe_tpu_torch.utils import profiling

#: the host scopes of one gate: the gate itself and the two steps before its PBS
GATE_SCOPES = ("pbs.gate", "pbs.lincomb", "pbs.test_vector")


def _recorded(run, name: str) -> bool:
    """Whether the traced window holds a program scope ``name``."""
    return run.trace is not None and run.trace.scope_counts.get(name, 0) > 0


def counter_per_request(run, name: str) -> float | None:
    """The counter ``name`` over the window's requests; 0 where the program
    counts PBS calls but never this."""
    if not _recorded(run, "pbs.gate") or not run.served or not hasattr(profiling, "counters"):
        return None
    counters = profiling.counters()
    if "pbs.calls" not in counters:
        return None
    return counters.get(name, 0) / len(run.served)


def host_ms_per_span(run, name: str) -> float | None:
    """The mean, over the window's ``name`` spans, of each one's traced host
    milliseconds less the card waits inside it."""
    if not _recorded(run, name) or not hasattr(profiling, "spans"):
        return None
    host = [(s.end_ns - s.start_ns) / 1e6 - s.wait_s * 1e3
            for s in profiling.spans() if s.name == name and s.end_ns is not None]
    return statistics.fmean(host) if host else None


def host_ms_outside_children(run, name: str, child: str) -> float | None:
    """The mean, over the window's ``name`` spans, of each one's traced host
    milliseconds outside its direct ``child`` spans, less the card waits
    there too."""
    if not _recorded(run, name) or not hasattr(profiling, "spans"):
        return None
    spans = [s for s in profiling.spans() if s.end_ns is not None]
    inside_ns, inside_wait_s = defaultdict(int), defaultdict(float)
    for s in spans:
        if s.name == child:
            inside_ns[s.parent] += s.end_ns - s.start_ns
            inside_wait_s[s.parent] += s.wait_s
    host = [(s.end_ns - s.start_ns - inside_ns[s.id]) / 1e6 - (s.wait_s - inside_wait_s[s.id]) * 1e3
            for s in spans if s.name == name]
    return statistics.fmean(host) if host else None


def idle_pct_under(run, scopes) -> float | None:
    """Idle device seconds the trace put down to the innermost host scope
    being one of ``scopes``, over the traced window, in %."""
    if not _recorded(run, scopes[0]) or run.trace.window_s <= 0:
        return None
    idle = sum(seconds for label, seconds in run.trace.idle_s_by_host.items()
               if label.split(" / ", 1)[0] in scopes)
    return 100.0 * idle / run.trace.window_s
