from benchmark import spans


def read(run):
    """Device idle while the host runs a graph's eager first run, captures
    it or replays it the first time."""
    return spans.idle_pct_under(run, spans.GRAPH_SETUP)
