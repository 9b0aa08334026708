"""Idle device time under pbs.gate, pbs.lincomb or pbs.test_vector, in % of the traced window."""

from benchmark.benchlib.program_trace import GATE_SCOPES, idle_pct_under


def read(run):
    return idle_pct_under(run, GATE_SCOPES)
