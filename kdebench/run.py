"""Run one benchmark cell once on the card and print its result line.

    python3 kdebench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout (the cells are BENCHMARK.json's workloads).
--trace 0 reports the cell's end-to-end metrics, --trace 1 its per-layer
metrics from one profiled stretch of the window.  The last line of
standard output is the result (JSON); the numbers compared with the
reference end standard error, each beside its limit.  Exits non-zero, and
prints no result, without enough CUDA cards, for an unknown name, when the
JAX package or JAX was loaded, or when the run fails otherwise.
"""

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
import traceback  # noqa: E402
from pathlib import Path  # noqa: E402

CHECKOUT = Path(__file__).resolve().parent.parent
# every build and kernel cache of the program inside the checkout, at fixed
# paths, so that only a checkout's first run builds (the port builds its
# kernels under build/kernels/ there by itself)
CACHES = {
    "TORCH_EXTENSIONS_DIR": CHECKOUT / "build" / "kdebench" / "torch_extensions",
    "TRITON_CACHE_DIR": CHECKOUT / "build" / "kdebench" / "triton",
    "CUDA_CACHE_PATH": CHECKOUT / "build" / "kdebench" / "cuda_cache",
}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    for key, path in CACHES.items():
        os.environ[key] = str(path)
    sys.path.insert(0, str(CHECKOUT))
    from kdebench import harness

    try:
        cell = harness.resolve(args.workload)
        import torch

        # one host thread: a second one sleeps between frames, and waking
        # it for a frame's staging copy sent a share of frames' host path
        # from ~1.5 to 6-9 ms in some runs and not in others
        torch.set_num_threads(1)
        if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
            raise harness.BenchError(f"the cell needs {cell.chips} CUDA card(s) and this "
                                     "machine has fewer: the benchmark runs on the card only")
        result = harness.run(cell, args.seed, args.seconds, bool(args.trace),
                             device=torch.device("cuda", 0), t_process=T_PROCESS)
    except Exception as exc:  # the run gives no result: say why, exit non-zero
        traceback.print_exc()
        print(f"kdebench: no result: {exc}", file=sys.stderr)
        return 1
    for line in result.pop("log"):
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
