"""Tokens trained in the window (steps x batch x seq) over its whole time,
from the first ``step`` call to the closing synchronize."""


def read(run):
    w = run.window
    if w is None:
        return None
    return w.steps * run.traffic["batch"] * run.traffic["seq"] / w.seconds
