"""Seconds of the program's keygen core, make_server_key, ending in a sync (host clock)."""

def read(run):
    return run.setup["keygen_s"]
