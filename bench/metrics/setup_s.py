"""Process start to the first timed query (host clock): the device's
start, the kernels' build or load, the corpus and weights, the
thresholds' calibration, the engine, one warm query."""


def read(run):
    return run.setup_s if run.setup_s > 0 else None
