def read(run):
    """Device operations of the traced calls per epoch they ran."""
    tr = run.trace
    if tr is None:
        return None
    epochs = sum(run.driver.epochs_run[-run.wl["trace_calls"]:])
    return sum(n for _, n in tr.ops.values()) / epochs if epochs else None
