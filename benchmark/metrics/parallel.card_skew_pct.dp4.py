"""The slowest card's blind-rotation device time over the mean card's, less 1, in %."""

from benchmark.benchlib.readers import card_skew_pct as read  # noqa: F401
