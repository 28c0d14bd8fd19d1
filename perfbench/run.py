"""The benchmark of atq_tpu_torch: one run of one cell on one card.

    python3 -m perfbench.run --workload bert-base.s512 --seed 7 \\
        --seconds 10 --trace 0

prints, as its last line on standard output, one JSON object: ``correct``,
``attempted`` and ``failed`` steps, the cell's metrics (its end-to-end ones,
or with ``--trace 1`` its per-layer ones), the device, with ``--trace 1`` a
``breakdown`` of the traced window, and last ``check``: each number the
correctness check compared, with its limit. Those numbers are also the last
lines on standard error. A run that finds no CUDA device, or fewer than the
cell asks for, or that finds JAX or the JAX package loaded once its window
has closed, exits with a code other than 0 and prints no result.
"""

import time

_START = time.monotonic()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
CACHE = ROOT / ".perfbench_cache"


def process_age() -> float:
    """Seconds since this process started (its start time in /proc), or
    since this module was imported where /proc is not there."""
    try:
        with open("/proc/self/stat") as f:
            started = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return uptime - started / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return time.monotonic() - _START


def card_line() -> str:
    """The card's name, power limit and clocks, as nvidia-smi reads them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm,"
             "clocks.max.sm,temperature.gpu", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30)
        return out.stdout.strip() or out.stderr.strip()
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi not available: {e}"


def parse_args(argv=None):
    p = argparse.ArgumentParser(prog="python3 -m perfbench.run",
                                description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "nv")):
        os.environ.setdefault(var, str(CACHE / sub))
    import torch

    from perfbench import harness

    cell = harness.load_cell(args.workload, bool(args.trace))
    if not torch.cuda.is_available() \
            or torch.cuda.device_count() < cell.chips:
        seen = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"perfbench: {args.workload} needs {cell.chips} CUDA "
              f"device(s); torch sees {seen}", file=sys.stderr)
        return 2
    result = harness.execute(cell, args.seed, args.seconds, bool(args.trace),
                             torch.device("cuda", 0), process_age)
    found = harness.forbidden_modules()
    if found:
        print(f"perfbench: the run loaded {found}", file=sys.stderr)
        return 3
    print(f"card: {card_line()}")
    print(f"readings {json.dumps(result['readings'])}", file=sys.stderr)
    for name, row in result["check"].items():
        print(f"check {name} {row['value']!r} limit {row['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
