def read(run):
    """Device time launched inside the integrand's spans, over the traced
    calls' device time."""
    tr = run.trace
    return None if tr is None or tr.device_s <= 0 else 100.0 * tr.integrand_s / tr.device_s
