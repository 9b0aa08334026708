"""Ciphertexts bootstrapped (pbs.ciphertexts) per addition, in the traced window."""

from benchmark.benchlib.program_trace import counter_per_request


def read(run):
    return counter_per_request(run, "pbs.ciphertexts")
