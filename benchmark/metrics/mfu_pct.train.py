from benchmark import readers


def read(run):
    """The flow's forward and backward FLOPs per trained sample."""
    return readers.mfu_pct(run, ("fwd", "bwd"), "samples")
