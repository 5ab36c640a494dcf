def read(run):
    proposals = sum(c["proposals"] for c in run.calls)
    return 100.0 * sum(c["events"] for c in run.calls) / proposals if proposals else None
