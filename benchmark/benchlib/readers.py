"""Arithmetic the metric readers share (``metrics/<name>.py``).  Each
returns None where its run has nothing to read, and the harness then leaves
the metric out of the result line."""

from __future__ import annotations

import statistics

from benchmark.benchlib.roofline import bound_seconds

ROTATION = "pbs.blind_rotate"
OUTSIDE_ROTATION = ("pbs.mod_switch", "pbs.sample_extract", "pbs.key_switch")


def percentile_ms(run, q: int) -> float | None:
    """The q-th percentile of the requests' latencies (issue to synchronised
    outputs), over every request of the window."""
    lat = [(s.t_done - s.t_issue) * 1e3 for s in run.served]
    if len(lat) < 2:  # one request is its own percentile
        return lat[0] if lat else None
    return statistics.quantiles(lat, n=100, method="inclusive")[q - 1]


def device_seconds(run, scopes) -> float:
    return sum(run.trace.device_s_by_scope.get(s, 0.0) for s in scopes)


def rotation_roofline_pct(run) -> float | None:
    """The schoolbook bound of every blind rotation of the window over the
    device time the ``pbs.blind_rotate`` scopes launched."""
    if run.trace is None:
        return None
    busy = device_seconds(run, (ROTATION,))
    bounds = [bound_seconds(run.p, b, run.card) for s in run.served for b in s.pbs_batches]
    if busy <= 0 or None in bounds:
        return None
    return 100.0 * sum(bounds) / busy


def outside_rotation_pct(run) -> float | None:
    """Device time under the PBS's other three scopes, as a share of all
    device time under ``pbs.*``."""
    if run.trace is None:
        return None
    outside = device_seconds(run, OUTSIDE_ROTATION)
    total = outside + device_seconds(run, (ROTATION,))
    return 100.0 * outside / total if total > 0 else None


def idle_pct(run) -> float | None:
    """The share of the traced window in which no device activity ran."""
    if run.trace is None or run.trace.busy_s <= 0:
        return None
    return 100.0 * (1.0 - run.trace.busy_s / run.trace.window_s)


def collective_pct(run) -> float | None:
    """Device time of NCCL kernels, summed over the cards, over the traced
    windows summed over the cards, in %.  An NCCL kernel on a card that
    arrives first spins until its peers do, so this counts the wait for the
    slowest card too."""
    if run.card_traces is None or run.trace.window_s <= 0:
        return None
    nccl = [s for name, s in run.trace.device_s_by_name.items() if "nccl" in name.lower()]
    return 100.0 * sum(nccl) / run.trace.window_s if nccl else None


def card_skew_pct(run) -> float | None:
    """How far the slowest card's blind rotations took longer than the mean
    card's: 100 * (max / mean - 1) of each card's ``pbs.blind_rotate``
    device seconds."""
    if run.card_traces is None:
        return None
    rotation = [t.device_s_by_scope.get(ROTATION, 0.0) for t in run.card_traces]
    mean = statistics.fmean(rotation)
    return 100.0 * (max(rotation) / mean - 1.0) if mean > 0 else None
