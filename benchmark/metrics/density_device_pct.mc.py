from benchmark import span_device


def read(run):
    """Device time launched inside the mixture's densities (``nf.mc.density``:
    the channel weights, the inverse kinematics and the flows' inverses),
    over the traced call's device time."""
    return span_device.pct_under(run, "nf.mc.density")
