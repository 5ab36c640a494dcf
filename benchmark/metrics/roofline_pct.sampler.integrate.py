from benchmark import readers


def read(run):
    return readers.roofline_pct(run, [("pwquad_sampler_kernel", "sampler", run.wl["neval"])])
