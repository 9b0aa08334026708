"""Seconds from the first line of run.py to the window's start (host clock)."""

def read(run):
    return run.setup["setup_s"]
