"""Device time of the PBS outside the blind rotation, as a share of the PBS's."""

from benchmark.benchlib.readers import outside_rotation_pct as read  # noqa: F401
