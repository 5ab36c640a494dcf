def read(run):
    """The program's ``FLOW_INVERSES`` over the window's calls, per epoch:
    C^2 a minibatch and the pilot's C^2 a call; ``None`` where the program
    does not count them."""
    counted = [c["flow_inverses"] for c in run.calls]
    if not counted or None in counted:
        return None
    return sum(counted) / sum(c["epochs"] for c in run.calls)
