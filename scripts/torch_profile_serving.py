#!/usr/bin/env python3
"""Where the time of the port's serving path goes, on one CUDA card.

    python3 scripts/torch_profile_serving.py [--out out/torch_profile_serving.json]

Builds P2RNet at full width (configs/config_files/p2rnet_test.yaml, random
weights from seed 42) through the demo runner's ``build_model`` and reports:

* a batch-1 request split into phases on the host clock, with a
  synchronisation after each phase (load+copy, generate, parse with host
  NMS, per-class assembly, dumps); medians over 20 requests on the demo clip;
* torch.profiler over 10 batch-1 generate calls and 3 B=32 generate calls:
  device time by kernel, and the device's busy share of the window (sum of
  kernel and copy time over the window's host-clock length; one stream, so
  the kernels do not overlap).

Prints one summary line per item and writes everything as JSON to --out.
Needs a CUDA card; it does not fall back to the CPU.
"""

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from pose2room_tpu_torch.config.loader import CONFIG, read_to_dict  # noqa: E402
from pose2room_tpu_torch.data.dataset import load_demo_clip  # noqa: E402
from pose2room_tpu_torch.eval.parse import assembly_pred_map_cls, parse_predictions  # noqa: E402
from pose2room_tpu_torch.runners import common  # noqa: E402
from pose2room_tpu_torch.utils.vis import dump_predictions, write_ply_points  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEMO_CLIP = os.path.join(REPO, "demo", "inputs", "input_joints_1.npy")


def request_phases(model, folded, cfg, n=20):
    phases = {k: [] for k in ("load_copy", "generate", "parse_nms", "assemble", "dumps", "total")}
    dump_dir = os.path.join(cfg.config["log"]["vis_path"], "profile")
    for _ in range(n):
        t = [time.perf_counter()]
        joints_np = load_demo_clip(DEMO_CLIP, num_frames=768)[None]
        joints = torch.from_numpy(joints_np).cuda()
        torch.cuda.synchronize()
        t.append(time.perf_counter())
        end_points = model.generate(joints, folded=folded)
        torch.cuda.synchronize()
        t.append(time.perf_counter())
        eval_dict, parsed = parse_predictions(end_points, {"input_joints": joints}, cfg.eval_config)
        t.append(time.perf_counter())
        eval_dict = assembly_pred_map_cls(eval_dict, parsed, cfg.eval_config)
        t.append(time.perf_counter())
        dump_predictions(dump_dir, end_points, eval_dict, parsed)
        write_ply_points(joints_np[0, ::12].reshape(-1, 3), os.path.join(dump_dir, "skeleton_points.ply"))
        t.append(time.perf_counter())
        for key, a, b in zip(phases, t[:-1], t[1:]):
            phases[key].append((b - a) * 1e3)
        phases["total"].append((t[-1] - t[0]) * 1e3)
    return {k: {"median_ms": float(np.median(v)), "max_ms": float(np.max(v)), "n": len(v)}
            for k, v in phases.items()}


def profile_generate(model, folded, x, calls):
    for _ in range(2):
        model.generate(x, folded=folded)
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(calls):
            model.generate(x, folded=folded)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = {}
    for e in prof.key_averages():
        if getattr(e, "device_type", None) != torch.autograd.DeviceType.CUDA:
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = e.self_cuda_time_total
        kernels[e.key] = kernels.get(e.key, 0.0) + us / 1e3
    busy_ms = sum(kernels.values())
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:15]
    return {
        "calls": calls,
        "window_ms": wall_ms,
        "device_busy_ms": busy_ms,
        "device_busy_share": busy_ms / wall_ms if wall_ms else None,
        "per_call_device_ms": busy_ms / calls,
        "top_kernels_ms_per_call": [(k, v / calls) for k, v in top],
    }


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=os.path.join(REPO, "out", "torch_profile_serving.json"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("torch_profile_serving: needs a CUDA card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    result = {"device": smi, "torch": torch.__version__}
    with tempfile.TemporaryDirectory() as workdir:
        config = read_to_dict(os.path.join(REPO, "configs", "config_files", "p2rnet_test.yaml"))
        config.update(finetune=False, seed=42)
        config["log"]["path"] = workdir
        cfg = CONFIG(config, mode="demo")
        try:
            model = common.build_model(cfg, device="cuda")
            t0 = time.perf_counter()
            folded = model.fold_eval()
            torch.cuda.synchronize()
            result["fold_ms"] = (time.perf_counter() - t0) * 1e3
            request_phases(model, folded, cfg, n=3)  # warm-up
            result["request_phases"] = request_phases(model, folded, cfg)
            clip = torch.from_numpy(load_demo_clip(DEMO_CLIP, num_frames=768)[None]).cuda()
            result["generate_b1"] = profile_generate(model, folded, clip, calls=10)
            result["generate_b32"] = profile_generate(model, folded, clip.expand(32, -1, -1, -1).contiguous(),
                                                      calls=3)
        finally:
            cfg.close()
    print(f"[{smi}] fold once per weight load: {result['fold_ms']:.3f} ms (host clock, first call)")
    for k, v in result["request_phases"].items():
        print(f"[{smi}] batch-1 request phase {k}: median {v['median_ms']:.3f} ms, max {v['max_ms']:.3f} ms (n={v['n']})")
    for name in ("generate_b1", "generate_b32"):
        g = result[name]
        print(f"[{smi}] {name}: window {g['window_ms']:.3f} ms over {g['calls']} calls, device busy "
              f"{g['device_busy_ms']:.3f} ms (share {g['device_busy_share']:.3f}), "
              f"{g['per_call_device_ms']:.3f} ms device per call")
        for k, v in g["top_kernels_ms_per_call"]:
            print(f"    {v:9.4f} ms/call  {k[:110]}")
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(result, f, indent=1)


if __name__ == "__main__":
    main()
