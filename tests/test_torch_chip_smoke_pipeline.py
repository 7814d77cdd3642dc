"""chip_smoke.py's data pipeline phase, the parts that need no card, on the
CPU: stages 1-3 in memory, the HDF5 branch (generate_samples, the split
CLI, the read-back through P2RNetDataset, DatasetConfig(split=) on the
written prior) and the render CLIs.  A card's host may lack h5py and
matplotlib, and then only the in-memory branch runs there; this holds the
other branch to the same samples and the same split."""

import os
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402
from pose2room_tpu_torch.ops.boxes import rot2head  # noqa: E402


def _gt_dump(dump_dir, sample):
    """A test run's dump of one batch, with the sample's GT boxes as its
    predictions too (the layout of utils/vis.py:dump_predictions)."""
    obbs = np.array([[*n["centroid"], *n["size"], rot2head(np.asarray(n["R_mat"]))] for n in sample["object_nodes"]])
    cls = np.array([int(n["class_id"][0]) for n in sample["object_nodes"]])
    os.makedirs(dump_dir)
    np.savez(os.path.join(dump_dir, "000000_pred_confident_nms_bbox.npz"), obbs=obbs, cls=cls,
             inst_idx=np.ones(len(cls), bool))
    np.savez(os.path.join(dump_dir, "000000_gt_bbox.npz"), obbs=obbs, cls=cls)
    return dump_dir


@pytest.fixture(scope="module")
def pipeline(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("pipeline"))
    cwd = os.getcwd()
    os.chdir(root)  # as pipeline_phase: DatasetConfig reads the prior under ./datasets
    try:
        samples = chip_smoke.pipeline_datagen(root)
        yield root, samples, chip_smoke.pipeline_files(root, samples)
    finally:
        os.chdir(cwd)


def test_files_branch_splits_as_the_in_memory_branch(pipeline):
    """The HDF5 branch's split CLI and the in-memory branch's
    generate_splits rule hold out the same samples."""
    root, samples, split = pipeline
    assert sorted(split["train"] + split["val"]) == sorted(samples)
    assert (len(split["train"]), len(split["val"])) == (19, 5)
    assert chip_smoke.pipeline_split_in_memory(root, samples) == split


@pytest.mark.parametrize("has_h5py", [True, False])
def test_render_clis(pipeline, has_h5py):
    """Each render CLI writes a PNG above 10 kB, with the sample file and
    (as where h5py is absent) without it."""
    root, samples, split = pipeline
    name = split["val"][0]
    dump_dir = _gt_dump(os.path.join(root, f"dump_{has_h5py}", f"test_0_{name}"), samples[name])
    for png in ("results.png", "sample.png"):
        if os.path.exists(os.path.join(root, png)):
            os.remove(os.path.join(root, png))
    chip_smoke.pipeline_render(root, dump_dir, name, has_h5py)
    assert os.path.getsize(os.path.join(root, "results.png")) > 10_000
    assert os.path.isfile(os.path.join(root, "sample.png")) == has_h5py
