#!/usr/bin/env python3
"""Dump a seeded CPU run of the port, to find where two machines part ways.

    python3 scripts/torch_cpu_trace.py --out run_a.npz
    python3 scripts/torch_cpu_trace.py --compare run_a.npz run_b.npz

The run, all on the CPU in f32, at the small shape (T=96, 64 seeds, 16
proposals, 10 gaussians) or with ``--full`` at the full width of
p2rnet_test.yaml (T=768, 512 seeds, 128 proposals, 100 gaussians; then
each tensor is stored as its CRC-32, sum and sum of magnitudes, which keeps
the dump small): two synthetic scenes from numpy's RandomState(5)
through ``SceneDataset``, the model's weights from torch.Generator seed 42
(as ``runners/common.build_model`` makes them), then ``generate`` on both clips
and the detection losses.  It stores, in the order they arise, the scenes'
items, every parameter and buffer after the init, the output of every
module call (a global forward hook) and every loss, each under a key that
says what made it, with torch's and numpy's versions.

``--compare`` walks two dumps in that order and prints the first key whose
values differ (with its largest difference; for digests, whose CRC-32
differs), then how many others differ.
"""

import argparse
import collections
import os
import sys
import zlib

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from pose2room_tpu_torch.data import synth  # noqa: E402
from pose2room_tpu_torch.data.dataset import SceneDataset  # noqa: E402
from pose2room_tpu_torch.data.loader import collate  # noqa: E402
from pose2room_tpu_torch.models.loss import detection_loss  # noqa: E402
from pose2room_tpu_torch.models.p2rnet import P2RNet, P2RNetConfig  # noqa: E402

SHAPES = {"small": dict(num_frames=96, num_seeds=64, num_proposals=16, num_gaussian=10),
          "full": dict(num_frames=768, num_seeds=512, num_proposals=128, num_gaussian=100)}


def flatten(prefix, value, out):
    """Every tensor or array inside value (nested dicts, lists, tuples)."""
    if isinstance(value, torch.Tensor):
        out[prefix] = value.detach().cpu().float().numpy() if value.is_floating_point() else value.cpu().numpy()
    elif isinstance(value, np.ndarray):
        out[prefix] = value
    elif isinstance(value, dict):
        for k, v in value.items():
            flatten(f"{prefix}/{k}", v, out)
    elif isinstance(value, (list, tuple)):
        for i, v in enumerate(value):
            flatten(f"{prefix}/{i}", v, out)


def digest(a):
    """[CRC-32 of the bytes, sum, sum of magnitudes] of an array."""
    a = np.ascontiguousarray(a)
    return np.array([zlib.crc32(a.tobytes()), a.astype(np.float64).sum(), np.abs(a.astype(np.float64)).sum()])


def run(shape):
    torch.manual_seed(0)
    records = collections.OrderedDict()
    rng = np.random.RandomState(5)
    scenes = [synth.as_stored(*synth.make_scene(rng, n_objects=3, n_frames=120)) for _ in range(2)]
    batch = collate([SceneDataset(scenes, num_frames=shape["num_frames"])[i] for i in range(2)])
    flatten("data", {k: v for k, v in batch.items() if isinstance(v, (np.ndarray, torch.Tensor))}, records)

    model = P2RNet(P2RNetConfig(**shape), device="cpu", generator=torch.Generator().manual_seed(42))
    for name, t in model.state_dict().items():
        flatten(f"init/{name}", t, records)

    names = {m: n for n, m in model.named_modules()}
    calls = collections.Counter()

    def hook(module, args, output):
        name = names.get(module, type(module).__name__)
        calls[name] += 1
        flatten(f"call/{len(calls):04d}.{sum(calls.values()):05d}/{name}#{calls[name]}/{type(module).__name__}",
                output, records)

    handle = torch.nn.modules.module.register_module_forward_hook(hook)
    try:
        tensors = {k: torch.as_tensor(v) for k, v in batch.items() if isinstance(v, (np.ndarray, torch.Tensor))}
        with torch.no_grad():
            end_points = model.generate(tensors["input_joints"], folded=model.fold_eval(),
                                        generator=torch.Generator().manual_seed(42))
            losses = detection_loss(end_points, tensors, 0)
    finally:
        handle.remove()
    flatten("generate", end_points, records)
    flatten("loss", losses, records)
    return records


def compare(a_path, b_path):
    a, b = np.load(a_path, allow_pickle=False), np.load(b_path, allow_pickle=False)
    order = [str(k) for k in a["_order"]]
    print(f"{a_path}: {a['_versions']}\n{b_path}: {b['_versions']}")
    digests = bool(a["_digests"]) and bool(b["_digests"])
    first, n_diff = None, 0
    for key in order:
        stored = key.replace("/", "|")
        if stored not in b.files:
            print(f"only in {a_path}: {key}")
            continue
        x, y = a[stored], b[stored]
        if digests:  # [CRC-32, sum, sum of magnitudes]: the sums' own rounding may differ
            x, y = x[:1], y[:1]
        if x.shape != y.shape or not np.array_equal(x, y):
            n_diff += 1
            if first is None:
                first = key
                gap = np.abs(x.astype(np.float64) - y.astype(np.float64)).max() if x.shape == y.shape else "shape"
                scale = np.abs(y.astype(np.float64)).max() if y.size else 0
                print(f"first difference: {key}  shape {x.shape} vs {y.shape}  max |diff| {gap}  "
                      f"(max |value| {scale}), {np.mean(x != y) if x.shape == y.shape else 1:.4f} of elements")
    print(f"{n_diff} of {len(order)} recorded tensors differ" + ("" if first else "; the runs agree bit for bit"))


def main():
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--out")
    p.add_argument("--compare", nargs=2)
    p.add_argument("--full", action="store_true", help="the full width, stored as digests")
    args = p.parse_args()
    if args.compare:
        compare(*args.compare)
        return
    records = run(SHAPES["full" if args.full else "small"])
    if args.full:
        records = collections.OrderedDict((k, digest(v)) for k, v in records.items())
    versions = f"torch {torch.__version__}, numpy {np.__version__}, threads {torch.get_num_threads()}"
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    np.savez_compressed(args.out, _order=np.array(list(records)), _versions=np.array(versions),
                        _digests=np.array(args.full),
                        **{k.replace("/", "|"): v for k, v in records.items()})
    print(f"{len(records)} tensors -> {args.out} ({versions})")


if __name__ == "__main__":
    main()
