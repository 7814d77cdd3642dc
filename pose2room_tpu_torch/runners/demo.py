"""Demo (serving) runner: raw .npy pose clips -> predicted boxes.

Port of pose2room_tpu/runners/demo.py (reference demo.py).  Headless: each
request's predictions are dumped as .npz / .json / .ply (utils/vis.py) in the
reference formats.  The model comes from ``runners.common.setup``: the
config's ``method``, then ``resume`` or ``finetune`` as in training.  The
model folds its graph operands once per weight load and every request
reuses them.  In a process group (data or tensor parallel) every rank
serves every clip, the ranks of a model group together, and rank 0 alone
writes the dumps.
"""

import glob
import os
import time

import numpy as np
import torch

from pose2room_tpu_torch.data.dataset import load_demo_clip
from pose2room_tpu_torch.device import resolve_device
from pose2room_tpu_torch.eval.parse import assembly_pred_map_cls, parse_predictions
from pose2room_tpu_torch.parallel.mesh import make_grid, model_parallel_of
from pose2room_tpu_torch.runners.common import setup
from pose2room_tpu_torch.utils.vis import dump_predictions, write_ply_boxes, write_ply_points


def run(cfg, device=None):
    """Serve every clip under ``<demo_path>/inputs/*.npy`` (or ``<demo_path>/*.npy``).

    Returns [(path, dump_dir, n_confident_boxes, request_seconds), ...]; a
    request is load, generate, parse, NMS and dumps, timed on the host clock
    (the parse copies its results to the host, which waits for the card).
    """
    make_grid(model_parallel_of(cfg.config))
    demo_path = cfg.config.get("demo_path", "demo")
    inputs = sorted(glob.glob(os.path.join(demo_path, "inputs", "*.npy")))
    if not inputs:
        inputs = sorted(glob.glob(os.path.join(demo_path, "*.npy")))
    if not inputs:
        cfg.log_string(f"No demo .npy inputs under {demo_path}")
        return []
    device = resolve_device(device)
    model = setup(cfg, device)[0]
    folded = model.fold_eval()

    data_cfg = cfg.config["data"]
    dump_threshold = cfg.config.get("generation", {}).get("dump_threshold", 0.5)
    results = []
    for path in inputs:
        t0 = time.perf_counter()
        joints_np = load_demo_clip(
            path,
            num_frames=data_cfg.get("num_frames", 768),
            use_height=not data_cfg.get("no_height", True),
        )[None]  # (1,T,V,3)
        joints = torch.from_numpy(joints_np).to(device)
        # deterministic whatever test.multi_mode says, as the JAX demo serves
        end_points = model.generate(joints, folded=folded)
        eval_dict, parsed = parse_predictions(end_points, {"input_joints": joints}, cfg.eval_config)
        eval_dict = assembly_pred_map_cls(eval_dict, parsed, cfg.eval_config)

        name = os.path.splitext(os.path.basename(path))[0]
        dump_dir = os.path.join(cfg.config["log"]["vis_path"], f"demo_{name}")
        if cfg.is_main_process:
            dump_predictions(dump_dir, end_points, eval_dict, parsed, dump_threshold=dump_threshold)
            npz = os.path.join(dump_dir, "000000_pred_confident_nms_bbox.npz")
            if os.path.isfile(npz):
                with np.load(npz) as data:
                    write_ply_boxes(data["obbs"], os.path.join(dump_dir, "pred_boxes.ply"))
            write_ply_points(
                joints_np[0, :: max(1, joints_np.shape[1] // 64)].reshape(-1, 3),
                os.path.join(dump_dir, "skeleton_points.ply"),
            )
        n_boxes = int(np.logical_and(
            parsed["obj_prob"][0] > dump_threshold, eval_dict["pred_mask"][0] == 1
        ).sum())
        seconds = time.perf_counter() - t0
        cfg.log_string(f"{path}: {n_boxes} confident boxes -> {dump_dir} ({seconds:.4f} s)")
        results.append((path, dump_dir, n_boxes, seconds))
    return results
