from benchmark import readers


def read(run):
    """Over the samples proposed."""
    return readers.mfu_pct(run, ("sampler",), "proposals")
