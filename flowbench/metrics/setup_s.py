"""Process start to the window's start: kernel build or load, weights,
pools, warm-up and the pre-roll's traffic."""


def read(run):
    return run.setup_s
