from benchmark import spans


def read(run):
    """Device idle while the host folds the weights (``nf.fold``)."""
    return spans.idle_pct_under(run, ("nf.fold",))
