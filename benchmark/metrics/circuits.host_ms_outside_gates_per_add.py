"""Mean traced host ms of a circuits.ripple_carry_add span outside its pbs.gate spans and card waits."""

from benchmark.benchlib.program_trace import host_ms_outside_children


def read(run):
    return host_ms_outside_children(run, "circuits.ripple_carry_add", "pbs.gate")
