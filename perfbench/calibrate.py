"""Readings behind a cell's check limits: the control and planted faults.

    python3 -m perfbench.calibrate --workload bert-base.s512 --seeds 1 2 3 \\
        --out calibrate.json

For each seed, the float32 reference's readings of the cell's three steps
are compared (perfbench/check.py ``gaps``) with those of the reference put
in the program's place:

- ``control``: computed in float8 e4m3 with a per-tensor scale (the
  precision below the configuration's bfloat16) wherever the program
  rounds to bfloat16;
- ``half_batch``: the loss's mean taken over the first half of the rows;
- ``label_altered``: the first row's label moved by one class (an answer
  altered where it is produced);
- ``frozen``: a step that returns its state unchanged.

The program's own readings (the lower ones) come from the benchmark's
runs, whose ``check`` key prints them. The benchmark's runs do not run
this.
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

from perfbench.check import gaps, reference_readings, worst_readings
from perfbench.harness import load_cell
from perfbench.reference import fp8

VARIANTS = ("control", "half_batch", "label_altered", "frozen")


def _planted(name: str, cell) -> dict:
    """``reference_readings``'s arguments for one variant."""
    return {"control": {"low": fp8},
            "half_batch": {"rows": cell.traffic["batch"] // 2},
            "label_altered": {"alter_label": True},
            "frozen": {"frozen": True}}[name]


def readings(cell, seed: int, device, names=VARIANTS) -> dict:
    """``{variant: numbers}`` of one seed: the compared ones and, for the
    record, the worst step's and the worst leaf's."""
    ref = reference_readings(cell.cfg, cell.traffic, seed, device)
    out = {}
    for name in names:
        got = reference_readings(cell.cfg, cell.traffic, seed, device,
                                 **_planted(name, cell))
        out[name] = {**gaps(got, ref), **worst_readings(got, ref)}
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python3 -m perfbench.calibrate",
                                description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--out", required=True)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("perfbench.calibrate: no CUDA device", file=sys.stderr)
        return 2
    cell = load_cell(args.workload, traced=False)
    rows = {}
    for seed in args.seeds:
        rows[str(seed)] = readings(cell, seed, torch.device("cuda", 0))
        print(json.dumps({"seed": seed, **rows[str(seed)]}), flush=True)
    with open(args.out, "w") as f:
        json.dump({"workload": args.workload,
                   "device": torch.cuda.get_device_name(0),
                   "readings": rows}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
