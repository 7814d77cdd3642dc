"""tests/torch_golden.py's cache: a golden is computed once a run and read
back bit for bit; without xdist it stays in the session and nothing is
written."""

import os
import threading
import time

import numpy as np
import torch

from torch_golden import Goldens, goldens, shared  # noqa: F401  (goldens is a fixture)


def _arrays():
    """Seeded arrays of the goldens' kinds, with the values a careless copy
    would change: -0, NaN, a subnormal, bf16 and float64."""
    rng = np.random.RandomState(0)
    a = rng.randn(3, 5).astype(np.float32)
    a[0, :3] = (-0.0, np.nan, np.float32(1e-40))
    return {"losses": {"total": float(rng.rand()), "pos_ratio": 0.25},
            "eps": {"center": a, "size": rng.randn(2, 4, 1, 3)},
            "grads": {"w": torch.from_numpy(rng.randn(4, 4)).to(torch.bfloat16), "b": torch.arange(3.0).double()}}


def _bits(tree):
    if isinstance(tree, dict):
        return {k: _bits(v) for k, v in tree.items()}
    if torch.is_tensor(tree):
        return (str(tree.dtype), tuple(tree.shape), tree.view(torch.uint8).numpy().tobytes()
                if tree.dtype == torch.bfloat16 else tree.numpy().tobytes())
    if isinstance(tree, np.ndarray):
        return (tree.dtype.str, tree.shape, tree.tobytes())
    return (type(tree).__name__, repr(tree))


def test_second_request_reads_the_saved_arrays_bit_for_bit(tmp_path):
    calls = []

    def compute():
        calls.append(1)
        return _arrays()

    first = shared("case", compute, str(tmp_path), who="gw0")
    second = shared("case", compute, str(tmp_path), who="gw1")
    assert len(calls) == 1 and second is not first
    assert _bits(second) == _bits(first) == _bits(_arrays())
    log = (tmp_path / "golden.log").read_text().splitlines()
    assert [line.split(" in ")[0] for line in log] == ["case computed by gw0", "case read by gw1"]


def test_concurrent_requests_compute_once(tmp_path):
    """Two requests at once (each its own lock file descriptor, as two
    workers hold): one computes, the other waits and reads."""
    calls, out = [], {}

    def compute():
        calls.append(1)
        time.sleep(0.5)
        return _arrays()

    threads = [threading.Thread(target=lambda w=w: out.update({w: shared("case", compute, str(tmp_path), w)}))
               for w in ("gw0", "gw1")]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
        assert not t.is_alive()
    assert len(calls) == 1 and _bits(out["gw0"]) == _bits(out["gw1"])


def test_without_xdist_nothing_is_written(tmp_path, monkeypatch):
    """In one process: computed once, each request its own copy (a caller
    that changes its copy changes no other), nothing on disk."""
    monkeypatch.chdir(tmp_path)
    calls, memo = [], {}
    g = Goldens(memo=memo)
    first = g._get("case", lambda: calls.append(1) or _arrays())
    first["eps"]["center"][:] = 0
    second = g._get("case", lambda: calls.append(1) or _arrays())
    assert len(calls) == 1 and list(memo) == ["case"]
    assert _bits(second) == _bits(_arrays())
    assert os.listdir(tmp_path) == []


def test_goldens_live_in_this_run_alone(goldens, worker_id, tmp_path_factory):
    """Under xdist the cache is the run's own ``pytest-<N>/torch_golden``;
    without it there is none."""
    if worker_id == "master":
        assert goldens.cache_dir is None
    else:
        base = tmp_path_factory.getbasetemp()
        assert base.name == f"popen-{worker_id}"
        assert goldens.cache_dir == str(base.parent / "torch_golden")
