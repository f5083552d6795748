"""Seconds from the process start to the window opening: imports, the
kernels' build (first run in a checkout) or load, weights, BatchNorm
calibration and folding, the frame pool, warm-up of every request shape."""


def read(run):
    return run.setup_s
