from benchmark import readers


def read(run):
    return readers.p95_ms(run)
