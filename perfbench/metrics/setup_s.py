"""Seconds from the process's start to the first timed step: imports, the
kernel library's load (and build, in a fresh checkout), the model's build,
the seeded inputs, the three checked steps and the warm-up."""


def read(run):
    return run.setup_s
