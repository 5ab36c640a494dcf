from benchmark import readers


def read(run):
    return readers.mfu_pct(run, ("sampler",), "samples")
