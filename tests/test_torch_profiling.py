"""The port's layer spans and the loader's CPU counter, on the CPU.

* ``annotate`` is one shared null context while no profiler records, and
  records the operator ``p2r/<name>`` under ``torch.profiler.profile``;
* a SMALL train step (``batch_to_device`` + ``train_step``) and a SMALL
  ``generate`` under the profiler record each of their spans once, every
  one a span of ``SPANS`` and inside the span of the call around it;
  together with 2s-AGCN's forward and the DDP gradient hook they record
  every span of ``SPANS``;
* ``DataLoader.stats`` counts the batches, the items and their CPU seconds
  in both worker modes, the batches stay those of a loader without workers,
  and ``reset_stats`` zeroes the count.
"""

import contextlib

import numpy as np
import pytest
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from pose2room_tpu_torch.data import synth
from pose2room_tpu_torch.data.dataset import SceneDataset
from pose2room_tpu_torch.data.loader import DataLoader
from pose2room_tpu_torch.models.p2rnet import P2RNet, P2RNetConfig
from pose2room_tpu_torch.train.step import batch_to_device, train_step
from pose2room_tpu_torch.utils.profiling import PREFIX, SPANS, annotate

SMALL = dict(num_frames=96, num_seeds=64, num_proposals=16, num_gaussian=10)

# each span -> the span it sits in (None: the caller's)
TRAIN_SPANS = {
    "train/h2d": None,
    "train/step": None,
    "model/forward": "train/step",
    "model/noise": "model/forward",
    "model/backbone": "model/forward",
    "model/vote": "model/forward",
    "model/proposal": "model/forward",
    "model/heads": "model/forward",
    "train/loss": "train/step",
    "train/backward": "train/step",
    "train/optimizer": "train/step",
}
GENERATE_SPANS = {
    "model/generate": None,
    "model/backbone": "model/generate",
    "model/vote": "model/generate",
    "model/proposal": "model/generate",
    "model/heads": "model/generate",
}
# recorded by 2s-AGCN's forward (tests/test_torch_agcn.py) and by the DDP
# gradient hook (below)
OTHER_SPANS = {"agcn/forward", "agcn/gcn", "agcn/adjacency", "agcn/tcn", "train/allreduce"}


@pytest.fixture(scope="module")
def scenes():
    rng = np.random.RandomState(4)
    return [synth.as_stored(*synth.make_scene(rng, n_objects=3, n_frames=120)) for _ in range(6)]


def recorded_spans(prof):
    """{span: the span it sits in, or None} of the ``p2r/`` host events,
    each recorded once."""
    spans = [e for e in prof.events() if e.device_type == DeviceType.CPU and e.name.startswith(PREFIX)]
    # operators, not user annotations: the profiler credits a kernel only to
    # an operator open on the thread that launched it
    assert not any(e.is_user_annotation for e in spans)
    names = [e.name[len(PREFIX):] for e in spans]
    assert len(names) == len(set(names)), names
    out = {}
    for e in spans:
        parent = e.cpu_parent
        while parent is not None and not parent.name.startswith(PREFIX):
            parent = parent.cpu_parent
        out[e.name[len(PREFIX):]] = None if parent is None else parent.name[len(PREFIX):]
    return out


def test_annotate_records_only_under_the_profiler():
    off = annotate("model/noise")
    assert isinstance(off, contextlib.nullcontext) and annotate("train/step") is off
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with annotate("model/noise"):
            torch.arange(8.0).sum()
    with annotate("model/noise"):  # after the profiler: nothing more recorded
        torch.arange(8.0).sum()
    assert recorded_spans(prof) == {"model/noise": None}


@pytest.mark.parametrize("path", ["train", "generate"])
def test_step_records_the_spans_of_its_path(scenes, path):
    model = P2RNet(P2RNetConfig(**SMALL), device="cpu")
    loader = DataLoader(SceneDataset(scenes, num_frames=SMALL["num_frames"], augment=True), batch_size=2,
                        num_workers=0)
    batch = next(iter(loader))
    if path == "train":
        optimizer = torch.optim.AdamW(model.parameters(), lr=1e-3)
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            dev = batch_to_device(batch, "cpu")
            losses, _ = train_step(model, optimizer, dev, generator=torch.Generator().manual_seed(1),
                                   clip_norm=10.0)
        assert torch.isfinite(losses["total"])
        want = TRAIN_SPANS
    else:
        x = torch.from_numpy(batch["input_joints"])
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            end_points = model.eval().generate(x, folded=model.fold_eval())
        assert end_points["center"].shape == (2, SMALL["num_proposals"], 3)
        want = GENERATE_SPANS
    got = recorded_spans(prof)
    assert set(got) <= set(SPANS)
    assert got == want
    assert set(TRAIN_SPANS) | set(GENERATE_SPANS) | OTHER_SPANS == set(SPANS)


def test_ddp_gradient_hook_records_the_allreduce_span(monkeypatch):
    """A process group of one on the CPU (gloo): DDP's summing hook opens
    ``train/allreduce`` around each bucket's all-reduce."""
    import datetime
    import socket

    from pose2room_tpu_torch.parallel.mesh import init_distributed, shutdown, wrap_model

    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    for key, value in {"RANK": "0", "WORLD_SIZE": "1", "LOCAL_RANK": "0", "LOCAL_WORLD_SIZE": "1",
                       "MASTER_ADDR": "localhost", "MASTER_PORT": str(port)}.items():
        monkeypatch.setenv(key, value)
    assert init_distributed("cpu", timeout=datetime.timedelta(seconds=60)) == "gloo"
    try:
        model = wrap_model(torch.nn.Linear(8, 4))
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            model(torch.randn(16, 8)).sum().backward()
    finally:
        shutdown()
    assert recorded_spans(prof) == {"train/allreduce": None}


@pytest.mark.parametrize("worker_mode", ["thread", "process"])
def test_loader_counts_batches_items_and_cpu_seconds(scenes, worker_mode):
    dataset = SceneDataset(scenes, num_frames=SMALL["num_frames"], augment=True)
    loader = DataLoader(dataset, batch_size=4, shuffle=True, seed=3, num_workers=2, worker_mode=worker_mode)
    try:
        assert loader.stats == {"batches": 0, "items": 0, "cpu_s": 0.0}
        batches = list(loader)
        stats = dict(loader.stats)
        loader.reset_stats()
        assert loader.stats == {"batches": 0, "items": 0, "cpu_s": 0.0}
        again = list(loader)
    finally:
        loader.close()
    assert stats["batches"] == len(batches) == 2 and stats["items"] == len(scenes)
    assert stats["cpu_s"] > 0
    assert loader.stats["batches"] == 2 and loader.stats["items"] == len(scenes) and loader.stats["cpu_s"] > 0
    plain = list(DataLoader(dataset, batch_size=4, shuffle=True, seed=3, num_workers=0))
    for got in (batches, again):
        assert len(got) == len(plain)
        for a, b in zip(got, plain):
            assert a.keys() == b.keys()
            for k in a:
                assert np.array_equal(a[k], b[k]), k
