"""Test runner: AP evaluation of the test split.

Port of pose2room_tpu/runners/test.py (reference test.py + test_epoch.py).
Per batch: ``generate`` on the folded weights, the device half of the
prediction parse and the GT corners, and the detection loss are dispatched
to the device and their results start copying to the host; then the host
stage of the PREVIOUS batch runs (NMS, per-class assembly, AP accumulation,
loss means, dumps) while the device works on this one.  Per-class AP and
recall, mAP and AR come out for each ``test.ap_iou_thresholds`` entry.

``multi_mode`` and ``eval_mesh_ap`` are not ported and raise.
"""

import os
import time

import torch

from pose2room_tpu_torch import native
from pose2room_tpu_torch.data.loader import DataLoader
from pose2room_tpu_torch.device import resolve_device
from pose2room_tpu_torch.eval.ap import APCalculator
from pose2room_tpu_torch.eval.parse import (
    assembly_gt_map_cls,
    assembly_pred_map_cls,
    gt_corners,
    parse_groundtruths,
    parse_predictions,
    parse_predictions_device,
)
from pose2room_tpu_torch.models.loss import detection_loss
from pose2room_tpu_torch.runners.demo import build_model
from pose2room_tpu_torch.runners.train import split_datasets
from pose2room_tpu_torch.train.state import check_unported_keys
from pose2room_tpu_torch.train.step import batch_to_device
from pose2room_tpu_torch.utils.logger import LossRecorder
from pose2room_tpu_torch.utils.vis import dump_predictions


def resolve_test_batch_size(value):
    """'auto' is one sample per visible card; anything else is an int."""
    if value == "auto":
        return max(torch.cuda.device_count(), 1)
    return int(value)


def _to_host(obj):
    """Copies of every tensor in a nested dict / tuple to the host; from a
    card they go to pinned memory without waiting for it."""
    if torch.is_tensor(obj):
        return obj.to("cpu", non_blocking=True)
    if isinstance(obj, dict):
        return {k: _to_host(v) for k, v in obj.items()}
    if isinstance(obj, (tuple, list)):
        return type(obj)(_to_host(v) for v in obj)
    return obj


def run(cfg, device=None, dataset=None):
    """Evaluate the model of the config (``demo.build_model``: ``finetune`` /
    ``weight``, else random weights from ``seed``) on the test split.

    ``dataset``: an in-memory dataset (e.g. ``data.dataset.SceneDataset``)
    used instead of ``data.split``/test.json.  Returns {iou_thresh: metrics}.
    Also sets ``cfg.test_summary``: the mean losses, the seconds between
    successive batch completions, and the IoU path ('native' or 'numpy').
    """
    check_unported_keys(cfg.config)
    test_cfg = cfg.config.get("test", {}) or {}
    if test_cfg.get("multi_mode", False):
        raise NotImplementedError("multi_mode evaluation is not ported")
    if test_cfg.get("eval_mesh_ap", False):
        raise NotImplementedError("eval_mesh_ap (voxel-occupancy AP) is not ported")
    device = resolve_device(device)
    dataset = dataset if dataset is not None else split_datasets(cfg, ("test",))["test"]
    model = build_model(cfg, device)
    folded = model.fold_eval()
    eval_cfg = cfg.eval_config
    batch_size = resolve_test_batch_size(eval_cfg["batch_size"])
    if eval_cfg["batch_size"] == "auto":
        cfg.log_string(f"test.batch_size: auto -> {batch_size}")
    seed = int(cfg.config.get("seed", 42))
    device_cfg = cfg.config.get("device", {}) or {}
    loader = DataLoader(dataset, batch_size, shuffle=False, seed=seed,
                        num_workers=device_cfg.get("num_workers", 8) or 0,
                        worker_mode=device_cfg.get("worker_mode", "thread"))
    iou_path = native.path()
    cfg.log_string(f"{len(dataset)} test samples; IoU matrices on the {iou_path} path")

    origin = cfg.dataset_config.origin_joint_id
    thresholds = eval_cfg["ap_iou_thresholds"]
    calculators = {t: APCalculator(t, cfg.dataset_config.class2type) for t in thresholds}
    recorder = LossRecorder(batch_size)
    dump = eval_cfg["dump_results"]
    dump_threshold = cfg.config.get("generation", {}).get("dump_threshold", 0.5)
    generator = torch.Generator().manual_seed(seed)  # for seed_sampling: random
    n_batches = len(loader)
    start = last_done = time.perf_counter()
    batch_seconds = []

    def host_stage(it, batch, host, done):
        nonlocal last_done
        if done is not None:
            done.synchronize()
        eval_dict, parsed = parse_predictions(None, batch, eval_cfg, device_out=host["parse"])
        eval_dict = assembly_pred_map_cls(eval_dict, parsed, eval_cfg)
        gt_map = assembly_gt_map_cls(parse_groundtruths(batch, corners=host["corners"]))
        recorder.update_loss({k: float(v) for k, v in host["losses"].items()})
        for calc in calculators.values():
            calc.step(eval_dict["batch_pred_map_cls"], gt_map)
        # the time between successive batch completions: with the pipeline a
        # dispatch-to-finish span would count overlapped work twice
        now = time.perf_counter()
        batch_seconds.append(now - last_done)
        last_done = now
        cfg.log_string(f"Test batch {it + 1}/{n_batches}: {batch_seconds[-1]:.3f}s")
        if dump:
            dump_dir = os.path.join(cfg.config["log"]["vis_path"], f"test_{it}_{batch['sample_idx'][0]}")
            dump_predictions(dump_dir, {"pi": host["pi"]}, eval_dict, parsed, gt_data=batch,
                             dump_threshold=dump_threshold)

    pending = None
    try:
        with torch.no_grad():
            for it, batch in enumerate(loader):
                tensors = batch_to_device(batch, device)
                end_points = model.generate(tensors["input_joints"], folded=folded, generator=generator)
                host = _to_host({
                    "parse": parse_predictions_device(end_points, tensors, eval_cfg),
                    "corners": gt_corners(tensors["center_label"], tensors["size"], tensors["heading"]),
                    "losses": detection_loss(end_points, tensors, origin),
                    "pi": end_points["pi"] if dump else None,
                })
                done = None
                if device.type == "cuda":
                    done = torch.cuda.Event()
                    done.record()
                if pending is not None:
                    host_stage(*pending)
                pending = (it, batch, host, done)
            if pending is not None:
                host_stage(*pending)
    finally:
        loader.close()

    cfg.log_string(f"Test total elapsed: {time.perf_counter() - start:.2f}s")
    for calc in calculators.values():
        calc.synchronize_between_processes()
    means = recorder.means()
    cfg.log_string(f"Mean losses: {means}")
    cfg.test_summary = {"mean_losses": means, "batch_seconds": batch_seconds, "iou_path": iou_path}
    metrics_all = {}
    for t, calc in calculators.items():
        cfg.log_string(f"---------- iou_thresh: {t} ----------")
        metrics = calc.compute_metrics()
        for k, v in metrics.items():
            cfg.log_string(f"eval {k}: {v}")
        metrics_all[t] = metrics
    return metrics_all
