"""The port's data pipeline (pose2room_tpu_torch.datagen) against the JAX
package's on the same seeded inputs: stage 1 (programs), stage 2 (the
recording loop with a fake simulator), stage 3 (HDF5 samples), stage 4
(splits and the size prior) and the scanning helpers, file for file."""

import filecmp
import json
import os
import sys
import time

import h5py
import numpy as np
import pytest

from pose2room_tpu.config.dataset_config import CLASS_LABELS_RAW as JAX_CLASS_LABELS_RAW
from pose2room_tpu.datagen import programs as jax_programs
from pose2room_tpu.datagen import samples as jax_samples
from pose2room_tpu.datagen import scanning as jax_scanning
from pose2room_tpu.datagen import skeletons as jax_skeletons
from pose2room_tpu.datagen import splits as jax_splits
from pose2room_tpu_torch.config.dataset_config import CLASS_LABELS_RAW
from pose2room_tpu_torch.data.dataset import P2RNetDataset, SceneDataset
from pose2room_tpu_torch.datagen import programs, samples, scanning, skeletons, splits

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _rot_y(h):
    c, s = np.cos(h), np.sin(h)
    return np.array([[c, 0.0, -s], [0.0, 1.0, 0.0], [s, 0.0, c]])


def _scene(rng, F=60):
    """tests/test_datagen.py's recipe: an 8x3x8 m room, three raw-named
    objects, and a walk through it."""
    room_bbox = {"centroid": np.array([1.0, 1.5, -2.0]), "size": np.array([8.0, 3.0, 8.0]), "R_mat": np.eye(3)}
    nodes = []
    for raw in ("sofa", "bed", "tv"):
        h = rng.rand() * 2 - 1
        nodes.append({"class_name": raw, "centroid": room_bbox["centroid"] + rng.randn(3) * 1.0,
                      "size": rng.rand(3) + 0.4, "R_mat": _rot_y(h)})
    joints = rng.randn(F, 53, 3) * 0.2 + room_bbox["centroid"]
    joints[:, :, 0] += np.linspace(-2, 2, F)[:, None]
    return room_bbox, nodes, joints


def _h5_tree(path):
    """{dataset path: array} of an HDF5 file."""
    out = {}
    with h5py.File(path, "r") as f:
        f.visititems(lambda name, obj: out.__setitem__(name, obj[()]) if isinstance(obj, h5py.Dataset) else None)
    return out


def _assert_same_arrays(a, b):
    assert sorted(a) == sorted(b)
    for k in a:
        assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k


def _assert_same_tree(a, b):
    """Two directories hold the same relative files with the same bytes."""
    rel = lambda root: sorted(os.path.relpath(os.path.join(d, f), root)  # noqa: E731
                              for d, _, fs in os.walk(root) for f in fs)
    assert rel(a) == rel(b)
    for name in rel(a):
        assert filecmp.cmp(os.path.join(a, name), os.path.join(b, name), shallow=False), name


def test_process_recording_writes_jax_samples(tmp_path):
    room_bbox, nodes, joints = _scene(np.random.RandomState(0))
    (tmp_path / "jax").mkdir()
    (tmp_path / "port").mkdir()
    want = jax_samples.process_recording(joints, room_bbox, nodes, str(tmp_path / "jax" / "s1_r1_sc1_char"))
    got = samples.process_recording(joints, room_bbox, nodes, str(tmp_path / "port" / "s1_r1_sc1_char"))
    assert [os.path.basename(p) for p in got] == [os.path.basename(p) for p in want]
    assert len(got) == 8
    built = samples.build_samples(joints, room_bbox, nodes)
    for path_g, path_w, sample in zip(got, want, built):
        tree = _h5_tree(path_g)
        _assert_same_arrays(tree, _h5_tree(path_w))
        # build_samples holds exactly what was written
        flat = {"skeleton_joints": sample["skeleton_joints"],
                "skeleton_joint_votes": sample["skeleton_joint_votes"],
                **{f"room_bbox/{k}": v for k, v in sample["room_bbox"].items()},
                **{f"object_nodes/{i}/{k}": v for i, node in enumerate(sample["object_nodes"])
                   for k, v in node.items()}}
        _assert_same_arrays(flat, tree)
    assert (built[0]["skeleton_joint_votes"][..., 0] > 0).any()

    # the in-memory path gives the items the file path gives
    split = tmp_path / "train.json"
    split.write_text(json.dumps(got))
    from_files = P2RNetDataset(str(split), num_frames=32)
    in_memory = SceneDataset([samples.stored_sample(s) for s in built], num_frames=32)
    for i in (0, 5):
        a, b = from_files[i], in_memory[i]
        for k in a:
            if k != "sample_idx":
                assert np.array_equal(a[k], b[k]), k


@pytest.mark.parametrize("reject", ["never_in_room", "never_near_an_object"])
def test_rejected_recordings(tmp_path, reject):
    room_bbox, nodes, joints = _scene(np.random.RandomState(1))
    if reject == "never_in_room":
        joints = joints + 100.0
    else:
        nodes = [dict(n, centroid=n["centroid"] + np.array([0.0, 0.0, 30.0])) for n in nodes]
    assert jax_samples.process_recording(joints, room_bbox, nodes, str(tmp_path / "j")) == []
    assert samples.process_recording(joints, room_bbox, nodes, str(tmp_path / "p")) == []
    assert samples.build_samples(joints, room_bbox, nodes) == []
    assert os.listdir(tmp_path) == []


def test_stage3_helpers_match_jax(tmp_path):
    rng = np.random.RandomState(2)
    data = rng.randn(5, 56, 3)
    path = tmp_path / "pd_script.txt"
    with open(path, "w") as f:
        for i in range(5):
            f.write(f"{i} " + " ".join(f"{x:.6f}" for x in data[i].ravel()) + "\n")
        f.write("\n1 2 3\n")  # a blank line and a short line are skipped
    got = samples.read_pd_script(str(path))
    assert got.shape == (5, 53, 3) and np.array_equal(got, jax_samples.read_pd_script(str(path)))

    assert samples.class_mapping(CLASS_LABELS_RAW) == jax_samples.class_mapping(JAX_CLASS_LABELS_RAW)
    room_bbox, nodes, joints = _scene(rng)
    for aug_idx in range(8):
        rb, nds, jts = samples.augment_8(room_bbox, nodes, joints, aug_idx)
        wrb, wnds, wjts = jax_samples.augment_8(room_bbox, nodes, joints, aug_idx)
        assert np.array_equal(jts, wjts)
        for a, b in zip([rb] + nds, [wrb] + wnds):
            for k in ("centroid", "R_mat"):
                assert np.array_equal(a[k], b[k]), (aug_idx, k)
        votes = samples.compute_votes(nds, jts, contact_dist=1.0)
        assert np.array_equal(votes, jax_samples.compute_votes(wnds, wjts, contact_dist=1.0))
    np.testing.assert_array_equal(samples.check_in_box(joints[:, 0], nodes[0]),
                                  jax_samples.check_in_box(joints[:, 0], nodes[0]))


def _sample_files(root, n_scene=3, n_room=2, n_char=2):
    """Written port samples named <scene>_<room>_<script>_<char>."""
    room_bbox, nodes, joints = _scene(np.random.RandomState(3))
    files = []
    for scene in range(n_scene):
        for room in range(n_room):
            for char in range(n_char):
                base = os.path.join(root, f"s{scene}_r{room}_sc0_char{'AB'[char]}")
                files += samples.process_recording(joints, room_bbox, nodes, base, augment=False)
    return files


@pytest.mark.parametrize("level", ["script_level", "char_level", "room_level"])
def test_splits_and_prior_match_jax(tmp_path, level):
    files = _sample_files(str(tmp_path))
    assert len(files) == 12
    keep = "charB" if level == "room_level" else None
    got = splits.generate_splits(files, str(tmp_path / "port" / level), level=level, seed=2, keep_char=keep)
    want = jax_splits.generate_splits(files, str(tmp_path / "jax" / level), level=level, seed=2, keep_char=keep)
    assert got == want and got["train"] and got["val"] == got["test"]
    splits.compute_avg_prior(got["train"], str(tmp_path / "port" / level))
    jax_splits.compute_avg_prior(want["train"], str(tmp_path / "jax" / level))
    _assert_same_tree(str(tmp_path / "port"), str(tmp_path / "jax"))


def scene_graph():
    """tests/test_programs.py's graph: one 8x3x8 room (floor + 2 walls), a
    sofa / fridge / tv to detect, a grabbable apple, a door + doorjamb, and
    an out-of-room bench."""
    def node(nid, cls, category, center, size, properties=(), states=()):
        return {"id": nid, "class_name": cls, "category": category, "properties": list(properties),
                "states": list(states), "bounding_box": {"center": list(center), "size": list(size)},
                "obj_transform": {"rotation": [1.0, 0.0, 0.0, 0.0]}}

    nodes = [
        node(1, "livingroom", "Rooms", [0, 1.5, 0], [8, 3, 8]),
        node(2, "floor", "Floors", [0, -0.05, 0], [8, 0.1, 8]),
        node(3, "wall", "Walls", [-4, 1.5, 0], [0.1, 3, 8]),
        node(4, "wall", "Walls", [4, 1.5, 0], [0.1, 3, 8]),
        node(10, "sofa", "Furniture", [2, 0.4, 2], [2.0, 0.8, 0.9], properties=["SITTABLE"]),
        node(11, "fridge", "Appliances", [-2, 1.0, 1], [0.9, 2.0, 0.9], properties=["CAN_OPEN", "CONTAINERS"],
             states=["CLOSED"]),
        node(12, "tv", "Electronics", [3, 1.0, -3], [1.2, 0.7, 0.2], properties=["HAS_SWITCH"], states=["OFF"]),
        node(20, "apple", "Props", [0.5, 0.9, -1], [0.1, 0.1, 0.1], properties=["GRABBABLE"]),
        node(30, "door", "Doors", [0, 1.0, -3.9], [1.0, 2.0, 1.4]),
        node(31, "doorjamb", "Decor", [0, 1.0, -3.95], [1.0, 2.1, 0.2]),
        node(40, "bench", "Furniture", [100, 0.4, 100], [1.5, 0.5, 0.5], properties=["SITTABLE"]),
    ]
    edges = [{"from_id": i, "to_id": 1, "relation_type": "INSIDE"} for i in (10, 11, 12, 20, 40)]
    return {"nodes": nodes, "edges": edges}


@pytest.mark.parametrize("n_seq", [2, 100])
def test_generate_room_programs_matches_jax(tmp_path, n_seq):
    """n_seq=2: fewer than the 3! orderings, so the balanced probabilities
    and the seeded draws; 100: more, so every permutation."""
    got = programs.generate_room_programs(scene_graph(), 0, CLASS_LABELS_RAW, out_dir=tmp_path / "port",
                                          scene_id=0, n_seq=n_seq, seed=5)
    want = jax_programs.generate_room_programs(scene_graph(), 0, JAX_CLASS_LABELS_RAW, out_dir=tmp_path / "jax",
                                               scene_id=0, n_seq=n_seq, seed=5)
    assert got["scripts"] == want["scripts"] and got["instance_ids"] == want["instance_ids"]
    assert {n["class_name"] for n in got["nodes_for_det"]} == {"sofa", "fridge", "tv"}
    _assert_same_tree(str(tmp_path / "port"), str(tmp_path / "jax"))
    probe = lambda script: not any("fridge" in c for c in script)  # noqa: E731
    got = programs.generate_room_programs(scene_graph(), 0, CLASS_LABELS_RAW, probe=probe, n_seq=n_seq)
    want = jax_programs.generate_room_programs(scene_graph(), 0, JAX_CLASS_LABELS_RAW, probe=probe, n_seq=n_seq)
    assert got["scripts"] == want["scripts"] and len(got["nodes_for_det"]) == 2


class FakeSim:
    """UnityCommunication-surface fake (tests/test_programs.py:172): writes
    a pd_script.txt recording; hangs or fails on chosen output paths."""

    def __init__(self, trajectory, hang=(), fail=()):
        self.trajectory, self.hang, self.fail, self.closed = trajectory, tuple(hang), tuple(fail), False

    def reset(self, scene_id):
        self.scene = scene_id

    def expand_scene(self, graph):
        return (True,)

    def add_character(self, name, initial_room=None):
        self.character = name

    def render_script(self, script, output_folder=None, **kw):
        if any(h in output_folder for h in self.hang):
            time.sleep(30)
        if any(h in output_folder for h in self.fail):
            return False, "render failed"
        out = os.path.join(output_folder, "script", "0")
        os.makedirs(out, exist_ok=True)
        with open(os.path.join(out, "pd_script.txt"), "w") as f:
            for i, frame in enumerate(self.trajectory):
                f.write(f"{i} " + " ".join(f"{x:.5f}" for x in frame.ravel()) + "\n")
        return True, None

    def close(self):
        self.closed = True


def _trajectory(F=40):
    """A 56-joint walk from the sofa to the fridge inside the room."""
    rng = np.random.RandomState(0)
    hips = np.stack([np.linspace(2, -2, F), np.full(F, 0.9), np.linspace(2, 1, F)], axis=1)
    return hips[:, None, :] + rng.randn(F, 56, 3) * 0.05


def _stage2(package, root):
    """Stage 1 then stage 2 twice under ``root`` with one package: the first
    simulator hangs on script 0 / Male1, and every one fails on script 1 /
    Female2."""
    prog, skel, labels = package
    prog.generate_room_programs(scene_graph(), 0, labels, out_dir=root / "script_bbox", scene_id=0, n_seq=2)
    sims = []

    def make_sim():
        first = not sims
        sims.append(FakeSim(_trajectory(), hang=("0/Male1",) if first else (), fail=("1/Female2",)))
        return sims[-1]

    logs = []
    runs = [skel.render_recordings(make_sim, root / "script_bbox", root / "recording", {"0": scene_graph()},
                                   characters=("Chars/Male1", "Chars/Female2"), timeout_s=1, log=logs.append)
            for _ in range(2)]
    rel = lambda paths: [os.path.relpath(p, root) for p in paths]  # noqa: E731
    stats = [{k: rel(v) if isinstance(v, list) else v for k, v in s.items()} for s in runs]
    return stats, [s.closed for s in sims], [os.path.relpath(m.split(": ")[1].split(";")[0], root) for m in logs]


def test_render_recordings_matches_jax(tmp_path):
    (tmp_path / "port").mkdir()
    (tmp_path / "jax").mkdir()
    got = _stage2((programs, skeletons, CLASS_LABELS_RAW), tmp_path / "port")
    want = _stage2((jax_programs, jax_skeletons, JAX_CLASS_LABELS_RAW), tmp_path / "jax")
    assert got == want
    (first, second), closed, _ = got
    assert first["restarts"] == 1 and closed == [True, False, False]  # the second run starts its own
    assert len(first["failed"]) == 2 and first["recorded"]
    assert second["recorded"] == [] and second["restarts"] == 0
    assert len(second["skipped"]) == len(first["recorded"]) + len(first["failed"])
    _assert_same_tree(str(tmp_path / "port"), str(tmp_path / "jax"))  # recordings, blacklist, stage-1 files


def _camera():
    K = np.array([[80.0, 0.0, 32.0], [0.0, 80.0, 24.0], [0.0, 0.0, 1.0]])
    return K


def _depth(h=48, w=64, z=3.0, seed=0):
    rng = np.random.RandomState(seed)
    depth = np.full((h, w), z, dtype=np.float32) + rng.rand(h, w).astype(np.float32) * 0.2
    depth[:4] = 0.0  # no reading
    depth[-3:] = 20.0  # beyond far_clip
    return depth


def test_scanning_matches_jax():
    K = _camera()
    RTs = [np.eye(4), np.eye(4)]
    RTs[1][:3, :3] = _rot_y(0.3)
    RTs[1][:3, 3] = [0.2, 0.1, -0.3]
    rgb = (np.random.RandomState(1).rand(48, 64, 3) * 255).astype(np.uint8)
    for i, RT in enumerate(RTs):
        got = scanning.pc_from_depth(_depth(seed=i), K, RT, rgb_img=rgb, sample_rate=2)
        want = jax_scanning.pc_from_depth(_depth(seed=i), K, RT, rgb_img=rgb, sample_rate=2)
        for a, b in zip(got, want):
            assert np.array_equal(a, b)
    bnds = np.array([[-2.0, 2.0], [-2.0, 2.0], [0.5, 4.0]])
    vols = []
    for module in (scanning, jax_scanning):
        vol = module.TSDFVolume(bnds, voxel_size=0.1)
        for i, RT in enumerate(RTs):
            vol.integrate(_depth(seed=i), K, RT, rgb_img=rgb)
        vols.append(vol)
    got, want = vols
    assert (got.weight > 0).any()
    for name in ("tsdf", "weight", "color"):
        assert np.array_equal(getattr(got, name), getattr(want, name)), name
    assert np.array_equal(got.surface_points(), want.surface_points())
    assert np.array_equal(scanning.get_view_frustum(_depth(), K, RTs[1]),
                          jax_scanning.get_view_frustum(_depth(), K, RTs[1]))

    room = {"centroid": np.array([0.0, 1.5, 0.0]), "size": np.array([8.0, 3.0, 8.0]), "R_mat": np.eye(3)}
    boxes = [{"centroid": np.array([1.0, 1.0, 1.0]), "size": np.array([2.0, 2.0, 2.0]), "R_mat": _rot_y(0.4)}]
    for a, b in zip(scanning.generate_cameras(room, boxes), jax_scanning.generate_cameras(room, boxes)):
        assert np.array_equal(a, b)
    P = np.array([[1.2, 0.0, 0.05, 0.0], [0.0, 1.6, -0.02, 0.0], [0.0, 0.0, -1.0002, -0.020002], [0, 0, -1, 0]])
    got, want = scanning.get_cam_intrinsics(P, 64, 48), jax_scanning.get_cam_intrinsics(P, 64, 48)
    assert got.keys() == want.keys() and all(np.array_equal(got[k], want[k]) for k in got)
    W2C = np.eye(4)
    W2C[:3, 3] = [0.5, -1.0, 2.0]
    assert np.array_equal(scanning.get_cam_extrinsics(W2C), jax_scanning.get_cam_extrinsics(W2C))


def test_stage1_to_stage4_pipeline_feeds_the_port_dataset(tmp_path):
    """Scene graph -> programs -> (fake simulator) recordings -> HDF5
    samples -> splits -> the port's P2RNetDataset."""
    from pose2room_tpu_torch.datagen import generate_room_programs, generate_samples, generate_splits, render_recordings

    generate_room_programs(scene_graph(), 0, CLASS_LABELS_RAW, out_dir=tmp_path / "script_bbox", scene_id=0, n_seq=2)
    render_recordings(lambda: FakeSim(_trajectory()), tmp_path / "script_bbox", tmp_path / "recording",
                      {"0": scene_graph()}, characters=("Chars/Male1",), timeout_s=0)
    files = generate_samples(str(tmp_path / "recording"), str(tmp_path / "samples"), augment=False, n_workers=2)
    assert len(files) == 2  # two scripts, one character, no augmentation
    generate_splits(files, str(tmp_path / "splits" / "script_level"), seed=2)
    ds = P2RNetDataset(str(tmp_path / "splits" / "script_level" / "train.json"), num_frames=32)
    item = ds[0]
    assert item["input_joints"].shape == (32, 53, 3)
    assert item["box_label_mask"].sum() == 3


def _run_jax_script(name, argv, monkeypatch):
    import runpy

    monkeypatch.setattr(sys, "argv", [name, *argv])
    runpy.run_path(os.path.join(REPO, "scripts", name), run_name="__main__")


def test_generate_and_split_clis_match_jax(tmp_path, monkeypatch, capsys):
    """scripts/torch_generate_samples.py and torch_split_samples.py against
    scripts/generate_samples.py and split_samples.py: the same flags, files
    and output line."""
    sys.path.insert(0, os.path.join(REPO, "scripts"))
    try:
        import torch_generate_samples
        import torch_split_samples
    finally:
        sys.path.remove(os.path.join(REPO, "scripts"))
    programs.generate_room_programs(scene_graph(), 0, CLASS_LABELS_RAW, out_dir=tmp_path / "script_bbox",
                                    scene_id=0, n_seq=2)
    skeletons.render_recordings(lambda: FakeSim(_trajectory()), tmp_path / "script_bbox", tmp_path / "recording",
                                {"0": scene_graph()}, characters=("Chars/Male1", "Chars/Female2"), timeout_s=0)
    rec = str(tmp_path / "recording")
    lines = {}
    for who, out in (("port", "samples"), ("jax", "samples_jax")):
        argv = ["--recordings", rec, "--out", str(tmp_path / out), "--workers", "2"]
        if who == "port":
            torch_generate_samples.main(argv)
        else:
            _run_jax_script("generate_samples.py", argv, monkeypatch)
        lines[who] = capsys.readouterr().out.replace(str(tmp_path / out), "<out>")
    assert lines["port"] == lines["jax"] == "wrote 32 samples to <out>\n"  # 2 scripts x 2 characters x 8
    _assert_same_tree(str(tmp_path / "samples"), str(tmp_path / "samples_jax"))

    for level in ("script_level", "char_level"):
        for who, out in (("port", "splits"), ("jax", "splits_jax")):
            argv = ["--samples", str(tmp_path / "samples"), "--out", str(tmp_path / out), "--level", level]
            if who == "port":
                torch_split_samples.main(argv)
            else:
                _run_jax_script("split_samples.py", argv, monkeypatch)
            lines[who] = capsys.readouterr().out
        assert lines["port"] == lines["jax"] and lines["port"].startswith(f"{level}: ")
    _assert_same_tree(str(tmp_path / "splits"), str(tmp_path / "splits_jax"))
