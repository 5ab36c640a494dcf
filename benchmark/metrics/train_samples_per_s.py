def read(run):
    return run.rate("samples")
