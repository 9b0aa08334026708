"""The blind rotations' schoolbook bound over their device time, in %."""

from benchmark.benchlib.readers import rotation_roofline_pct as read  # noqa: F401
