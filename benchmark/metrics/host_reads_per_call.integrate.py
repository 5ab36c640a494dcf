from benchmark import spans


def read(run):
    """Blocking device-to-host reads an ``integrate`` call makes."""
    return spans.host_reads_per_call(run, 4)
