"""NCCL kernels' device time over the traced windows, both summed over the cards, in %."""

from benchmark.benchlib.readers import collective_pct as read  # noqa: F401
