"""The share of the traced windows with no device activity, over every card, in %."""

from benchmark.benchlib.readers import idle_pct as read  # noqa: F401
