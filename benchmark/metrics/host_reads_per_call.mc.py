def read(run):
    """The program's ``HOST_READS`` a ``train_multichannel`` call, averaged
    over the window's calls; ``None`` where the program does not count the
    mixture's reads."""
    counted = [c["host_reads"] for c in run.calls]
    if not counted or None in counted:
        return None
    return sum(counted) / len(counted)
