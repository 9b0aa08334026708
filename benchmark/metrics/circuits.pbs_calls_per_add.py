"""pbs.blind_rotate scopes entered in the traced window per addition."""

def read(run):
    if run.trace is None or not run.served:
        return None
    return run.trace.scope_counts.get("pbs.blind_rotate", 0) / len(run.served)
