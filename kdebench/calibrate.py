"""The control's readings, for setting a cell's limits (limits/<cell>.json).

    python3 kdebench/calibrate.py --workload <cell> --seeds 1 2 3 [--steps 64]

prints, for each seed, one JSON line of the numbers check.py compares when
the reference in TF32 stands in the port's place (check.control_numbers):
the upper readings of the limits.  The lower readings are those of the
cell's own runs (run.py), which print the same numbers.  On the card only.
"""

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def main() -> int:
    from kdebench import check, harness

    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--steps", type=int, default=64)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("calibrate: no CUDA card", file=sys.stderr)
        return 1
    cell = harness.resolve(args.workload)
    for seed in args.seeds:
        t = time.perf_counter()
        ctx = harness.frames_context(cell, seed, 0.0, torch.device("cuda", 0))
        got = check.control_numbers(cell, ctx, args.steps)
        print(json.dumps({"workload": args.workload, "seed": seed, "control": got,
                          "seconds": time.perf_counter() - t}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
