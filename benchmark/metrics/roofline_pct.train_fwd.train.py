from benchmark import readers


def read(run):
    """The forward without statistics on every minibatch, with them on
    every statistics refresh's batch."""
    mb = run.cfg["training"]["mini_batch_size"]
    return readers.roofline_pct(run, [("train_fwd_kernel<false", "fwd", mb),
                                      ("train_fwd_kernel<true", "fwd_stats", min(mb, 1 << 16))])
