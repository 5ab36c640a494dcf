from benchmark import spans


def read(run):
    """Device idle while the host is in the unweighter (``nf.unweight``)
    outside the integrand."""
    return spans.idle_pct_under(run, ("nf.unweight",), exclude=("bench.integrand",))
