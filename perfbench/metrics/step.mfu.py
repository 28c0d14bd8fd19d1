"""The step's analytic matmul FLOPs (perfbench/flops.py, remat's recompute
not counted) over the traced window's time a step, as a share of the
card's dense bf16 peak."""

from perfbench.flops import PEAK_BF16, analytic_step_flops


def read(run):
    t = run.trace
    if t is None or not t.kernels:
        return None
    cfg, traffic = run.cfg, run.traffic
    flops = analytic_step_flops(cfg["hidden_size"], cfg["intermediate_size"],
                                cfg["num_hidden_layers"], traffic["seq"],
                                traffic["batch"], cfg["num_classes"])
    seconds = t.window_us / 1e6 / t.steps
    return 100.0 * flops / seconds / PEAK_BF16
