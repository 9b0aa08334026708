"""Seconds of with_key_form for the cell's impl, ending in a sync (host clock)."""

def read(run):
    return run.setup["keyform_s"]
