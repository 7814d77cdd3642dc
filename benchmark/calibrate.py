"""Readings that the limits of a cell are set from, many seeds in one
process (so the kernels build and load once):

    python benchmark/calibrate.py --workload <name> --seeds 11,12,... \
        [--control-seeds 21,22,23] [--seconds 2]

For each of ``--seeds`` a sound run of the program (set-up, a short window,
the comparison); for each of ``--control-seeds`` the control, the plain
reference with TF32 on put in the program's place, and planted faults:
a seed frame moved one frame on; for a generate cell one proposal's
centre moved 5 cm, for a train cell half the batch left out and the
update applied with the wrong sign (the optimizer's learning rate
negated: ascent); each judged by the same comparison.  One JSON line each: {"seed", "what", "numbers"}.  Needs the
card (TF32 exists only there); the runs of run.py do not run any of this.
"""

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def plant(outputs, fault):
    """A program's outputs with a planted fault: ``seed_shift`` moves the
    middle seed of every clip one frame on, ``answer`` moves the first
    proposal's centre 5 cm."""
    out = dict(outputs)
    if fault == "seed_shift":
        seeds = out["seed_inds"].clone()
        seeds[:, seeds.shape[1] // 2] += 1
        out["seed_inds"] = seeds
    elif fault == "answer":
        center = out["center"].clone()
        center[:, 0] += 0.05
        out["center"] = center
    return out


def program_numbers(cell, seed, seconds, device, fault=None):
    """A sound run of the program, its outputs judged as they are or with
    a planted ``fault`` (see ``plant``), or, with ``ascent``, a train run
    whose every update goes up the gradient."""
    from benchmark.harness import cells

    traffic = cells.traffic_of(cell, seed, device)
    if fault == "ascent":
        for group in traffic.optimizer.param_groups:
            group["lr"] = -group["lr"]
    traffic.warm()
    traffic.window(seconds)
    traffic.close()
    if fault in ("seed_shift", "answer"):
        if cell.traffic["kind"] == "train":
            traffic.record["end_points"][0] = plant(traffic.record["end_points"][0], fault)
        else:
            traffic.kept = [(k, plant(out, fault)) for k, out in traffic.kept]
    return traffic.numbers()


def control_numbers(cell, seed, device, half=False):
    """The reference in the program's place: TF32 on (the control), or in
    f32 with half of each batch left out (``half``, train cells)."""
    import torch

    from benchmark.harness import cells, checks
    from benchmark.reference.p2rnet import set_precision

    traffic = cells.traffic_of(cell, seed, device)
    traffic.close()
    m = cell.config["model"]
    try:
        set_precision(tf32=not half)
        if cell.traffic["kind"] == "train":
            batches, seeds = traffic.checked_inputs()
            rec = checks.reference_record(m, cell.config["optimizer"], traffic.weights0, batches, seeds,
                                          device, half=half)
            set_precision(tf32=False)
            return checks.train_numbers(m, cell.config["optimizer"], traffic.weights0, rec, batches, seeds,
                                        device)
        clips = traffic.pool[:traffic.batch]
        out = checks.reference_outputs(m, traffic.weights, clips, device)
        set_precision(tf32=False)
        return checks.generate_numbers(m, traffic.weights, clips, out, device)
    finally:
        set_precision(tf32=False)
        if device.type == "cuda":
            torch.cuda.empty_cache()


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", default="")
    p.add_argument("--control-seeds", default="")
    p.add_argument("--seconds", type=float, default=2.0)
    args = p.parse_args()
    import torch

    from benchmark.harness import spec
    from pose2room_tpu_torch import kernels

    if not torch.cuda.is_available():
        print("calibrate.py needs a CUDA card", file=sys.stderr)
        return 1
    device = torch.device("cuda", 0)
    kernels.timed_build()
    cell = spec.load_cell(ROOT, args.workload)
    seeds = [int(s) for s in args.seeds.split(",") if s]
    controls = [int(s) for s in args.control_seeds.split(",") if s]
    jobs = [(s, "program") for s in seeds] + [(s, "control_tf32") for s in controls]
    jobs += [(s, "fault_seed_shift") for s in controls]
    if cell.traffic["kind"] == "train":
        jobs += [(s, "fault_half_batch") for s in controls] + [(s, "fault_ascent") for s in controls]
    else:
        jobs += [(s, "fault_answer") for s in controls]
    for seed, what in jobs:
        t0 = time.perf_counter()
        if what == "program":
            nums = program_numbers(cell, seed, args.seconds, device)
        elif what in ("fault_seed_shift", "fault_answer", "fault_ascent"):
            nums = program_numbers(cell, seed, args.seconds, device, fault=what[len("fault_"):])
        else:
            nums = control_numbers(cell, seed, device, half=what == "fault_half_batch")
        print(json.dumps({"workload": args.workload, "seed": seed, "what": what, "numbers": nums,
                          "seconds": round(time.perf_counter() - t0, 1)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
