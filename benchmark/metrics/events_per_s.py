from benchmark import readers


def read(run):
    """Kish-effective unweighted events, (sum w)^2 / sum w^2 over every
    event of every completed call, per second of the window."""
    return readers.kish_rate(run)
