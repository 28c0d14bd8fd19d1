"""The share of the traced window in which no device event ran, in %."""


def read(run):
    t = run.trace
    if t is None or not t.kernels:
        return None
    return 100.0 * (t.window_us - t.busy_us) / t.window_us
