"""The port's headless viewers (pose2room_tpu_torch.utils.room_view and the
scripts/torch_render_*.py CLIs) against the JAX package's, in process, and
the CLIs as subprocesses that load neither JAX nor the JAX package."""

import importlib
import os
import runpy
import subprocess
import sys

import matplotlib.image
import numpy as np
import pytest

from pose2room_tpu.utils import room_view as jax_room_view
from pose2room_tpu_torch.datagen import process_recording
from pose2room_tpu_torch.utils import room_view
from pose2room_tpu_torch.utils.vis import write_ply_points

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _rot_y(h):
    c, s = np.cos(h), np.sin(h)
    return np.array([[c, 0.0, -s], [0.0, 1.0, 0.0], [s, 0.0, c]])


@pytest.fixture
def sample_file(tmp_path):
    """tests/test_room_view.py's sample: an 8x3x8 m room, a sofa and a tv,
    a 50-frame walk, written by the port's datagen."""
    rng = np.random.RandomState(0)
    room_bbox = {"centroid": np.array([0.0, 1.5, 0.0]), "size": np.array([8.0, 3.0, 8.0]), "R_mat": np.eye(3)}
    nodes = [{"class_name": raw, "centroid": room_bbox["centroid"] + rng.randn(3), "size": rng.rand(3) + 0.4,
              "R_mat": _rot_y(float(rng.rand() * 2 - 1))} for raw in ("sofa", "tv")]
    joints = rng.randn(50, 53, 3) * 0.2 + room_bbox["centroid"]
    joints[:, :, 0] += np.linspace(-2, 2, 50)[:, None]
    files = process_recording(joints, room_bbox, nodes, str(tmp_path / "s0_r0_sc0_c"), augment=False)
    assert files
    return files[0]


def test_helpers_match_jax(sample_file):
    got, want = room_view.read_sample_scene(sample_file), jax_room_view.read_sample_scene(sample_file)
    assert len(got[0]) == len(want[0]) == 2
    for a, b in zip(got[0], want[0]):
        assert a.keys() == b.keys() and all(np.array_equal(a[k], b[k]) for k in a)
        assert np.array_equal(room_view.node_corners(a), jax_room_view.node_corners(b))
    assert got[1].keys() == want[1].keys() and all(np.array_equal(got[1][k], want[1][k]) for k in got[1])
    assert np.array_equal(got[2], want[2])

    joints = got[2]
    for skip in (3, 10, 20):
        assert np.array_equal(room_view.get_even_dist_joints(joints, skip),
                              jax_room_view.get_even_dist_joints(joints, skip))
    flat = joints.reshape(-1, 3)
    assert np.array_equal(room_view.dist_node2bbox(got[0], flat, 53), jax_room_view.dist_node2bbox(want[0], flat, 53))
    assert np.array_equal(room_view.class_palette(), jax_room_view.class_palette())


def _decoded(path):
    assert os.path.getsize(path) > 10_000
    return matplotlib.image.imread(path)


def test_render_room_same_pixels_as_jax(tmp_path, sample_file):
    nodes, room_bbox, joints = room_view.read_sample_scene(sample_file)
    kw = dict(room_bbox=room_bbox, gt_nodes=nodes, pred_obbs=np.array([[0.0, 1.0, 0.0, 1.0, 1.0, 1.0, 0.3]]),
              pred_cls=np.array([3]), joints=joints, scene_points=np.random.RandomState(1).randn(5000, 3),
              skeleton_every=10, title="composite")
    got = room_view.render_room(str(tmp_path / "port.png"), **kw)
    jax_room_view.render_room(str(tmp_path / "jax.png"), **kw)
    assert got == str(tmp_path / "port.png")
    a, b = _decoded(tmp_path / "port.png"), _decoded(tmp_path / "jax.png")
    assert a.shape == b.shape and a.shape[-1] == 4
    assert np.array_equal(a, b)


# the child runs the script as __main__, then prints the modules it loaded
# that the chip machine does not have
CHILD = (
    "import runpy, sys\n"
    "sys.argv = sys.argv[1:]\n"
    "runpy.run_path(sys.argv[0], run_name='__main__')\n"
    "print('loaded:', sorted(k for k in sys.modules if k.split('.')[0] in "
    "('jax', 'jaxlib', 'flax', 'pose2room_tpu')))\n"
)


def _run_cli(script, *args):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", CHILD, os.path.join(REPO, "scripts", script), *args],
                         cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    lines = out.stdout.splitlines()
    assert lines[-1] == "loaded: []", lines[-1]
    return lines


def _pred_dump(dump_dir):
    dump_dir.mkdir()
    np.savez(dump_dir / "000000_pred_confident_nms_bbox.npz", obbs=np.array([[0.0, 0.5, 0.0, 1.0, 1.0, 1.0, 0.1]]),
             cls=np.array([5]), inst_idx=np.array([True]))
    np.savez(dump_dir / "000000_gt_bbox.npz", obbs=np.array([[1.0, 0.5, -1.0, 1.5, 1.0, 0.8, -0.4]]),
             cls=np.array([16]))
    return dump_dir


def test_torch_render_results_cli(tmp_path, sample_file):
    """The sample's room, GT and skeleton under a PLY scene overlay."""
    dump_dir = _pred_dump(tmp_path / "dump")
    write_ply_points(np.random.RandomState(0).randn(500, 3), str(tmp_path / "scene.ply"))
    out = tmp_path / "results.png"
    lines = _run_cli("torch_render_results.py", str(dump_dir), "--sample", sample_file, "--skeleton-every", "20",
                     "--scene-points", str(tmp_path / "scene.ply"), "--out", str(out))
    assert lines[-2] == f"wrote {out}"
    assert out.stat().st_size > 10_000


def _import_script(name):
    sys.path.insert(0, os.path.join(REPO, "scripts"))
    try:
        return importlib.import_module(name)
    finally:
        sys.path.remove(os.path.join(REPO, "scripts"))


def test_torch_render_results_gt_dumps_same_pixels_as_jax(tmp_path, monkeypatch, capsys):
    """Without a sample: the GT dumps' boxes; the port's CLI and
    scripts/render_results.py, in process, draw the same pixels."""
    dump_dir = _pred_dump(tmp_path / "dump")
    _import_script("torch_render_results").main([str(dump_dir), "--out", str(tmp_path / "port.png")])
    monkeypatch.setattr(sys, "argv", ["render_results.py", str(dump_dir), "--out", str(tmp_path / "jax.png")])
    runpy.run_path(os.path.join(REPO, "scripts", "render_results.py"), run_name="__main__")
    assert capsys.readouterr().out == f"wrote {tmp_path / 'port.png'}\nwrote {tmp_path / 'jax.png'}\n"
    assert np.array_equal(_decoded(tmp_path / "port.png"), _decoded(tmp_path / "jax.png"))


def test_torch_render_sample_cli(tmp_path, sample_file):
    out = tmp_path / "sample.png"
    lines = _run_cli("torch_render_sample.py", sample_file, "--out", str(out))
    assert lines[-2] == f"wrote {out}"
    assert out.stat().st_size > 10_000


def test_load_points_reads_npy_and_ply(tmp_path):
    torch_render_results = _import_script("torch_render_results")
    pts = np.random.RandomState(2).randn(40, 3)
    write_ply_points(pts, str(tmp_path / "p.ply"))
    np.save(tmp_path / "p.npy", pts)
    np.testing.assert_allclose(torch_render_results.load_points(str(tmp_path / "p.ply")), pts, rtol=1e-12)
    assert np.array_equal(torch_render_results.load_points(str(tmp_path / "p.npy")), pts)
