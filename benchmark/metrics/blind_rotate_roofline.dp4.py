"""Every card's blind rotations: their schoolbook bound over their device time, in %."""

from benchmark.benchlib.readers import rotation_roofline_pct as read  # noqa: F401
