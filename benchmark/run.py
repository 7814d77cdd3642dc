"""Run one cell of the benchmark of pose2room_tpu_torch once.

    python benchmark/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  The cell (BENCHMARK.json) names its
configuration, traffic mix and metrics; set-up makes the inputs and the
weights from the seed, builds the program's kernels (the first run of a
checkout compiles them into the package's build directory) and warms up
the cell's shapes; the window then runs for ``--seconds``; with
``--trace 1`` a traced window follows and the per-layer metrics are
printed in place of the end-to-end ones.  After the window the program's
outputs are compared with the plain reference (benchmark/reference).

The last line of standard output is the result, a JSON object; the last
lines of standard error give each compared number beside its limit.  Exit
code 1, and no result, without the cards the cell asks for, or when JAX
or the JAX package is loaded once the window has closed.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    from benchmark.harness import result, spec

    cell = spec.load_cell(ROOT, args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"{args.workload} needs {cell.chips} CUDA device(s); this machine has {n}", file=sys.stderr)
        return 1
    line = result.run_and_report(cell, args.seed, args.seconds, bool(args.trace),
                                 torch.device("cuda", 0), T_START)
    if line is None:
        return 1
    print(json.dumps(line))
    return 0


if __name__ == "__main__":
    sys.exit(main())
