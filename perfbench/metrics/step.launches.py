"""Device kernel events a step in the traced window: the host's load."""


def read(run):
    t = run.trace
    if t is None or not t.kernels:
        return None
    return len(t.kernels) / t.steps
