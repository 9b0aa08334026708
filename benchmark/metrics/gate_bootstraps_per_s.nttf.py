"""Gate bootstraps completed in the window over the window's seconds (host clock)."""

def read(run):
    return sum(s.units for s in run.served) / run.window_s
