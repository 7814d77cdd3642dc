"""A run whose timed path is broken underneath comes out not correct: the
harness's look for a card is skipped and the rest of a run is driven at a
tiny size on the CPU, once for each fault a cell can have.  (The exchange
between cards does not exist in these one-card cells.)"""

import time

import pytest
import torch

from benchmark.harness import cells, result, spec
from pose2room_tpu_torch.models.p2rnet import P2RNet
from pose2room_tpu_torch.train import step as port_step


def correct(root, workload, seed=2 ** 31 + 9):
    cell = spec.load_cell(root, workload)
    ctx = cells.run(cell, seed, 0.3, False, torch.device("cpu"), time.perf_counter())
    return result.line_of(ctx, False, torch.device("cpu"))["correct"]


def altered_answer(generate):
    def run(self, x, **kw):
        ep = generate(self, x, **kw)
        ep["center"] = ep["center"].clone()
        ep["center"][:, 0] += 0.05  # one proposal's centre 5 cm off, where it is produced
        return ep
    return run


def half_batch(generate):
    def run(self, x, **kw):
        ep = generate(self, x[: x.shape[0] // 2], **kw)
        return {k: torch.cat([v, v]) if torch.is_tensor(v) else v for k, v in ep.items()}
    return run


def state_unchanged(train_step):
    def run(model, optimizer, batch, **kw):
        before = {n: p.detach().clone() for n, p in model.named_parameters()}
        out = train_step(model, optimizer, batch, **kw)
        with torch.no_grad():
            for n, p in model.named_parameters():
                p.copy_(before[n])
        return out
    return run


def train_half_batch(train_step):
    def run(model, optimizer, batch, **kw):
        half = {k: v[: v.shape[0] // 2] for k, v in batch.items()}  # the loss is the mean over the rest
        return train_step(model, optimizer, half, **kw)
    return run


def ascent(train_step):
    def run(model, optimizer, batch, **kw):
        for group in optimizer.param_groups:  # every update goes up the gradient
            group["lr"] = -abs(group["lr"])
        return train_step(model, optimizer, batch, **kw)
    return run


@pytest.mark.parametrize("workload", ["tiny-generate-cell", "tiny-sparse-cell"])
@pytest.mark.parametrize("fault", [altered_answer, half_batch])
def test_generate_fault_is_not_correct(tiny_root, monkeypatch, workload, fault):
    assert correct(tiny_root, workload)
    monkeypatch.setattr(P2RNet, "generate", fault(P2RNet.generate))
    assert not correct(tiny_root, workload)


@pytest.mark.parametrize("fault", [state_unchanged, train_half_batch, ascent])
def test_train_fault_is_not_correct(tiny_root, monkeypatch, fault):
    assert correct(tiny_root, "tiny-train-cell")
    monkeypatch.setattr(port_step, "train_step", fault(port_step.train_step))
    assert not correct(tiny_root, "tiny-train-cell")
