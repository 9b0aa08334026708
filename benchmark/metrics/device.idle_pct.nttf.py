"""The share of the traced window with no device activity, in %."""

from benchmark.benchlib.readers import idle_pct as read  # noqa: F401
