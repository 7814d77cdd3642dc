"""Readings that the limits of a cell are set from, for a kind whose module
offers its own control (``control_numbers(cell, seed, device)``: the
``classify`` and ``ddp`` kinds), many seeds in one process:

    python benchmark/calibrate_kinds.py --workload <name> --seeds 11,12,... \
        [--control-seeds 21,22,23] [--seconds 2]

For each of ``--seeds`` a sound run of the program (set-up, a short window,
the comparison; ``calibrate.program_numbers``), for each of
``--control-seeds`` the kind's control, each judged by the same comparison.
One JSON line each: {"seed", "what", "numbers"}.  Needs the card; a ``ddp``
cell's ranks share it when it has fewer cards than ranks.
"""

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", default="")
    p.add_argument("--control-seeds", default="")
    p.add_argument("--seconds", type=float, default=2.0)
    args = p.parse_args()
    import torch

    from benchmark import calibrate
    from benchmark.harness import spec
    from pose2room_tpu_torch import kernels

    if not torch.cuda.is_available():
        print("calibrate_kinds.py needs a CUDA card", file=sys.stderr)
        return 1
    device = torch.device("cuda", 0)
    kernels.timed_build()
    cell = spec.load_cell(ROOT, args.workload)
    kind = spec.kind(ROOT, cell.traffic["kind"])
    jobs = [(int(s), "program") for s in args.seeds.split(",") if s]
    jobs += [(int(s), "control_tf32") for s in args.control_seeds.split(",") if s]
    for seed, what in jobs:
        t0 = time.perf_counter()
        if what == "program":
            nums = calibrate.program_numbers(cell, seed, args.seconds, device)
        else:
            nums = kind.control_numbers(cell, seed, device)
            torch.cuda.empty_cache()
        print(json.dumps({"workload": args.workload, "seed": seed, "what": what, "numbers": nums,
                          "seconds": round(time.perf_counter() - t0, 1)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
