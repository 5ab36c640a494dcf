from benchmark import readers


def read(run):
    return readers.idle_pct(run)
