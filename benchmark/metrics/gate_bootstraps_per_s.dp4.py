"""Gate bootstraps completed in the window on every card, over its seconds (host clock)."""

def read(run):
    return sum(s.units for s in run.served) / run.window_s
