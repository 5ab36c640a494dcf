from benchmark import readers


def read(run):
    mb = run.cfg["training"]["mini_batch_size"]
    return readers.roofline_pct(run, [("train_bwd", "bwd", mb)])
