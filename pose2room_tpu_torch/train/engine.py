"""Epoch loop: train and val phases, logging, best / last / final checkpoints.

Port of pose2room_tpu/train/engine.py (reference train_epoch.py:8-105):
the learning rate follows the epoch MultiStepLR; each epoch runs a train
phase and a val phase with running loss means, logs every ``print_step``
steps, saves ``model_last_<e>`` every ``save_weight_step`` epochs and
``model_best`` when the mean val loss improves, and ``model_final`` at the
end.  Losses are read one step late: the next step is already queued on
the card when the host waits for the previous step's numbers.

The MDN noise of step ``it`` of epoch ``e`` comes from a CPU generator
seeded ``seed * 1000003 + e * 100000 + it`` (the JAX package folds
``e * 100000 + it`` into its key): the same on the card and the CPU.
"""

import time

import torch

from pose2room_tpu_torch.train.state import epoch_lr, set_learning_rate
from pose2room_tpu_torch.train.step import batch_to_device, eval_step, train_step
from pose2room_tpu_torch.utils.logger import LossRecorder


def step_generator(seed, epoch, it):
    return torch.Generator().manual_seed(seed * 1000003 + epoch * 100000 + it)


def run_epoch(phase, epoch, loader, step_fn, device, seed, log_fn, print_step=10):
    """Run ``step_fn(batch, generator) -> losses`` over one epoch of
    ``loader``; returns the phase's LossRecorder."""
    recorder = LossRecorder(loader.batch_size)
    loader.set_epoch(epoch)
    n_batches = len(loader)
    ticks = []

    def drain(it, losses):
        values = torch.stack(list(losses.values())).cpu().tolist()  # waits for step it
        ticks.append(time.perf_counter())
        losses = dict(zip(losses, values))
        recorder.update_loss(losses)
        if it % print_step == 0:
            step_ms = 1e3 * (ticks[-1] - ticks[0]) / (len(ticks) - 1) if len(ticks) > 1 else 0.0
            log_fn(f"Process: Phase: {phase}. Epoch {epoch}: {it}/{n_batches}. "
                   f"step {step_ms:.1f}ms. "
                   f"Current loss: {dict((k, round(v, 5)) for k, v in losses.items())}.")

    pending = None
    for it, batch in enumerate(loader):
        losses = step_fn(batch_to_device(batch, device), step_generator(seed, epoch, it))
        if pending is not None:
            drain(*pending)
        pending = (it, losses)
    if pending is not None:
        drain(*pending)
    return recorder


def train(cfg, model, optimizer, base_lr, clip_norm, train_loader, val_loader, checkpoint,
          start_epoch=0, min_loss=float("inf")):
    """The full run.  Returns one {"train": means, "val": means} per epoch."""
    log = cfg.log_string
    config = cfg.config
    origin = cfg.dataset_config.origin_joint_id
    total_epochs = config["train"]["epochs"]
    sched = config.get("scheduler", {})
    milestones, gamma = sched.get("milestones", []), sched.get("gamma", 0.1)
    log_cfg = config.get("log", {})
    print_step = log_cfg.get("print_step", 10)
    save_weight_step = log_cfg.get("save_weight_step", 50)
    seed = int(config.get("seed", 42))
    device = model.device

    def train_fn(batch, generator):
        return train_step(model, optimizer, batch, generator=generator, clip_norm=clip_norm,
                          origin_joint_id=origin)[0]

    def val_fn(batch, generator):
        return eval_step(model, batch, generator=generator, origin_joint_id=origin)

    history = []
    for epoch in range(start_epoch, total_epochs):
        lr = epoch_lr(base_lr, milestones, gamma, epoch)
        set_learning_rate(optimizer, lr)
        log(f"-- Epoch {epoch + 1}/{total_epochs}; lr = {lr:.6g} --")
        start = time.time()
        train_rec = run_epoch("train", epoch, train_loader, train_fn, device, seed, log, print_step)
        val_rec = run_epoch("val", epoch, val_loader, val_fn, device, seed, log, print_step)
        log(f"Epoch {epoch + 1} elapsed: {time.time() - start:.2f}s")
        means = {"train": train_rec.means(), "val": val_rec.means()}
        for phase, m in means.items():
            log(f"Epoch {epoch + 1} mean {phase} losses: "
                f"{dict((k, round(v, 5)) for k, v in m.items())}")
        history.append(means)

        eval_loss = means["val"].get("total", float("inf"))
        if (epoch + 1) % save_weight_step == 0:
            checkpoint.save(f"last_{epoch + 1}", model, optimizer, epoch + 1, min_loss)
        if eval_loss < min_loss:
            min_loss = eval_loss
            checkpoint.save("best", model, optimizer, epoch + 1, min_loss)
            log(f"Best VAL loss so far: {min_loss:.5f}")
    checkpoint.save("final", model, optimizer, total_epochs, min_loss)
    return history
