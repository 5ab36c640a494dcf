from benchmark import mixture_work, yardstick


def read(run):
    """The mixture's matrix-product FLOPs per trained sample (one forward,
    C inverses, their backward; ``benchmark/mixture_work.py``) times the
    window's rate, over the float32 peak."""
    rate = run.rate("samples")
    if not rate:
        return None
    return 100.0 * mixture_work.flops_per_sample(run.cfg) * rate / yardstick.PEAK_F32_FLOPS
