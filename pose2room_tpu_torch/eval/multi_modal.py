"""Multi-modal evaluation: max-mAP over sampled runs + TMD diversity.

Port of pose2room_tpu/eval/multi_modal.py, host numpy.  Capability parity
with reference utils/eval/multi_modal_eval.py:36-101: given N test runs
produced with ``multi_mode: True`` (Bernoulli-sampled mixture modes),
compute (a) the element-wise max of per-run mAP scores scraped from each
run's log.txt, and (b) the Total Mutation Diversity:
per predicted instance, (class-entropy + 1) * (mean pairwise corner-distance
variance + 1), averaged over instances.

Usable as a library (``multi_modal_metrics``) or CLI:
    python -m pose2room_tpu_torch.eval.multi_modal <run_dir> [<run_dir> ...]
"""

import os
import re
import sys

import numpy as np

from pose2room_tpu_torch.ops.boxes import box_corners_from_params


def read_pred_npz(path):
    """Read one dumped prediction npz into instance dicts (inst_id keyed)."""
    data = np.load(path)
    inst_inds = np.where(data["inst_idx"])[0]
    out = []
    for inst_id, obb, cls_label in zip(inst_inds, data["obbs"], data["cls"]):
        out.append(
            {
                "inst_id": int(inst_id),
                "corners": np.asarray(
                    box_corners_from_params(obb[0:3], obb[3:6], obb[6])
                ),
                "class_id": int(cls_label),
            }
        )
    return out


def _entropy(freq):
    p = freq / freq.sum()
    p = p[p > 0]
    return float(-(p * np.log2(p)).sum())


def scrape_map_scores(run_dir):
    r"""All ``eval mAP: <x>`` values from a run's log.txt (one per threshold).
    The runner logs Python's repr, so an mAP below 1e-4 reads
    ``9.137427e-05``: the whole number is taken (JAX eval/multi_modal.py's
    ``\d+\.\d+`` takes 9.137427 of it)."""
    with open(os.path.join(run_dir, "log.txt")) as f:
        return [float(s) for s in re.findall(r"eval mAP: (\S+)", f.read())]


def multi_modal_metrics(run_dirs):
    """Returns (max_map_per_threshold, mean_TMD) over the given test runs."""
    map_list = [scrape_map_scores(d) for d in run_dirs]
    n = min(len(m) for m in map_list)
    max_map = np.max([m[:n] for m in map_list], axis=0) if n else np.array([])

    # collect per-(sample, instance) predictions across runs
    sample_names = None
    for d in run_dirs:
        vis = os.path.join(d, "visualization")
        names = sorted(os.listdir(vis)) if os.path.isdir(vis) else []
        sample_names = names if sample_names is None else sample_names
    stat = {}
    for sample in sample_names or []:
        stat.setdefault(sample, {})
        for d in run_dirs:
            npz = os.path.join(
                d, "visualization", sample, "000000_pred_confident_nms_bbox.npz"
            )
            if not os.path.isfile(npz):
                continue
            for inst in read_pred_npz(npz):
                rec = stat[sample].setdefault(
                    inst["inst_id"], {"box3d": [], "class_id": []}
                )
                rec["box3d"].append(inst["corners"])
                rec["class_id"].append(inst["class_id"])

    tmd = []
    for sample, inst_stat in stat.items():
        for inst_id, rec in inst_stat.items():
            _, freq = np.unique(rec["class_id"], return_counts=True)
            cls_entropy = _entropy(freq.astype(np.float64))
            boxes = np.asarray(rec["box3d"])  # (n, 8, 3)
            diff = boxes[:, None] - boxes[None]
            pair = np.mean(np.linalg.norm(diff, axis=-1), axis=-1)
            shape_var = float(np.mean(pair.sum(axis=-1)))
            tmd.append((cls_entropy + 1) * (shape_var + 1))
    return max_map, (float(np.mean(tmd)) if tmd else 0.0)


def main(argv=None):
    run_dirs = (argv or sys.argv[1:])
    if not run_dirs:
        print("usage: python -m pose2room_tpu_torch.eval.multi_modal <run_dir>...")
        return 1
    max_map, tmd = multi_modal_metrics(run_dirs)
    print("max mAP per threshold:", max_map)
    print("TMD:", tmd)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
