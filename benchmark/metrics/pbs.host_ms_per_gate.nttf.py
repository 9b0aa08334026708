"""Mean traced host ms of a pbs.gate span less its card waits, in the traced window."""

from benchmark.benchlib.program_trace import host_ms_per_span


def read(run):
    return host_ms_per_span(run, "pbs.gate")
