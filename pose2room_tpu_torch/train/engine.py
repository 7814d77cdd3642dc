"""Epoch loop: train and val phases, logging, best / last / final checkpoints.

Port of pose2room_tpu/train/engine.py (reference train_epoch.py:8-105):
at each epoch start the learning rate follows the epoch MultiStepLR (each
param group from its own base lr) and, with a ``bnscheduler:`` section,
every BatchNorm's momentum follows the BN-momentum schedule; each epoch
runs a train phase and a val phase with running loss means, logs every
``print_step`` steps and to TensorBoard (``LogBoard``), saves
``model_last_<e>`` every ``save_weight_step`` epochs and ``model_best``
when the mean val loss improves, and ``model_final`` at the end.  Losses
are read one step late: the next step is already queued on the card when
the host waits for the previous step's numbers.

``train.h2d_dtype`` compresses the target arrays of each batch on the way
to the device (``step.batch_to_device``); ``log.profile_steps > 0`` traces
train steps [3, 3 + profile_steps) into ``<save_path>/profile/``, with the
port's layer spans (``utils/profiling.py:SPANS``) inside each step.

The MDN noise of step ``it`` of epoch ``e`` comes from a CPU generator
seeded ``seed * 1000003 + e * 100000 + it`` (the JAX package folds
``e * 100000 + it`` into its key): the same on the card and the CPU.  With
the loader's epoch seeds, the optimizer state and the momentum recomputed
from the epoch, nothing else carries across epochs, so a resumed run
repeats an uninterrupted one.

Data parallel (``model`` wrapped by ``parallel.wrap_model``): every rank
draws the noise of the whole global batch from that generator and keeps its
rows (``shard``), matching the loader's strided shards, so N processes at
batch B train as one process at batch N*B on the same data (augmentation
aside: its seeds go by position in each shard).  The JAX package folds
``process_index`` into its key instead (JAX train/engine.py:183), a stream
the port cannot reproduce anyway.  The steps log global losses; each
phase's recorder is merged across processes all the same (idempotent), and
only rank 0 writes the board, the profile and the checkpoints, with a
barrier after each save.

Tensor parallel (``device.model_parallel``): each rank loads its strided
shard as above, and the model group gathers its ranks' batches in rank
order (``parallel.gather_batch``) and takes their rows of the noise
(``parallel.batch_shard``); every rank takes part in a save, which gathers
the shards, and rank 0 writes what one process writes.
"""

import os
import time

import torch

from pose2room_tpu_torch.parallel.collectives import barrier, batch_shard
from pose2room_tpu_torch.parallel.mesh import unwrap
from pose2room_tpu_torch.parallel.tensor import gather_batch
from pose2room_tpu_torch.train.state import apply_lr_schedule, bnm_momentum, lr_factor, optimizer_steps
from pose2room_tpu_torch.train.step import batch_to_device, eval_step, train_step
from pose2room_tpu_torch.utils.logger import LogBoard, LossRecorder
from pose2room_tpu_torch.utils.profiling import ProfileWindow, StepTimer


def step_generator(seed, epoch, it):
    return torch.Generator().manual_seed(seed * 1000003 + epoch * 100000 + it)


def run_epoch(phase, epoch, loader, step_fn, device, seed, log_fn, print_step=10, board=None,
              first_step=0, profile_window=None, h2d_dtype=None):
    """Run ``step_fn(batch, generator) -> losses`` over one epoch of
    ``loader``; returns (the phase's LossRecorder, the step count after it).

    ``first_step``: the optimizer's step count before the epoch; a train
    step adds one, and the board logs each train step's losses at the count
    after it and each val step's at the count of the state it ran on (JAX
    ``run_epoch``)."""
    recorder = LossRecorder(loader.batch_size)
    timer = StepTimer()
    loader.set_epoch(epoch)
    n_batches = len(loader)

    def drain(it, losses, step_no):
        values = torch.stack(list(losses.values())).cpu().tolist()  # waits for step it
        timer.tick()
        losses = dict(zip(losses, values))
        recorder.update_loss(losses)
        if it % print_step == 0:
            log_fn(f"Process: Phase: {phase}. Epoch {epoch}: {it}/{n_batches}. "
                   f"step {timer.mean_ms:.1f}ms. "
                   f"Current loss: {dict((k, round(v, 5)) for k, v in losses.items())}.")
        if board is not None:
            board.update(losses, step_no, phase)

    pending = None
    step_no = first_step
    for it, batch in enumerate(loader):
        if profile_window is not None:
            profile_window.maybe_start(step_no)
        losses = step_fn(batch_to_device(gather_batch(batch), device, h2d_dtype), step_generator(seed, epoch, it))
        if phase == "train":
            step_no += 1
        if profile_window is not None:
            profile_window.maybe_stop(step_no)
        if pending is not None:
            drain(*pending)
        pending = (it, losses, step_no)
    if pending is not None:
        drain(*pending)
    return recorder, step_no


def train(cfg, model, optimizer, base_lrs, clip_norm, train_loader, val_loader, checkpoint,
          start_epoch=0, min_loss=float("inf")):
    """The full run from ``start_epoch``.  ``model``: the P2RNet, or its
    ``parallel.wrap_model`` wrapper in a process group.  ``base_lrs``: each
    param group's base lr (``state.make_optimizer``).  Returns one
    {"train": means, "val": means} per epoch run (global means)."""
    log = cfg.log_string
    config = cfg.config
    origin = cfg.dataset_config.origin_joint_id
    total_epochs = config["train"]["epochs"]
    sched = config.get("scheduler", {})
    milestones, gamma = sched.get("milestones", []), sched.get("gamma", 0.1)
    bns_cfg = config.get("bnscheduler")
    base_lr = float(config.get("optimizer", {}).get("lr", 1e-3))  # the log line's
    log_cfg = config.get("log", {})
    print_step = log_cfg.get("print_step", 10)
    save_weight_step = log_cfg.get("save_weight_step", 50)
    seed = int(config.get("seed", 42))
    h2d_dtype = config["train"].get("h2d_dtype")
    net = unwrap(model)
    device = net.device
    main = cfg.is_main_process
    shard = batch_shard()
    board = LogBoard(enabled=main)

    def save(*args):
        checkpoint.save(*args, write=main)  # every rank: it gathers the tensor-parallel shards
        barrier()

    profile_steps = int(log_cfg.get("profile_steps", 0) or 0)
    profile_window = None
    if profile_steps > 0 and main:
        profile_dir = os.path.join(cfg.save_path, "profile")
        # skip the first steps (allocator and kernel warm-up); trace steady state
        profile_window = ProfileWindow(profile_dir, start_step=3, n_steps=profile_steps,
                                       cuda=device.type == "cuda")
        log(f"Profiling steps 3..{3 + profile_steps} -> {profile_dir}")

    def train_fn(batch, generator):
        return train_step(model, optimizer, batch, generator=generator, clip_norm=clip_norm,
                          origin_joint_id=origin, shard=shard)[0]

    def val_fn(batch, generator):
        return eval_step(net, batch, generator=generator, origin_joint_id=origin, shard=shard)

    history = []
    step_no = optimizer_steps(optimizer)
    for epoch in range(start_epoch, total_epochs):
        if bns_cfg:
            flax_m = bnm_momentum(bns_cfg, epoch)
            net.set_bn_momentum(flax_m)
            # reference BNMomentumScheduler.show_momentum (torch convention)
            log(f"Current BN decay momentum :{1.0 - flax_m:f}.")
        factor = lr_factor(milestones, gamma, epoch)
        apply_lr_schedule(optimizer, base_lrs, factor)
        log(f"-- Epoch {epoch + 1}/{total_epochs}; lr = {base_lr * factor:.6g} --")
        start = time.time()
        train_rec, step_no = run_epoch("train", epoch, train_loader, train_fn, device, seed, log,
                                       print_step, board, step_no, profile_window, h2d_dtype)
        val_rec, _ = run_epoch("val", epoch, val_loader, val_fn, device, seed, log, print_step,
                               board, step_no, h2d_dtype=h2d_dtype)
        log(f"Epoch {epoch + 1} elapsed: {time.time() - start:.2f}s")
        for rec in (train_rec, val_rec):
            rec.synchronize_between_processes()
        means = {"train": train_rec.means(), "val": val_rec.means()}
        for phase, m in means.items():
            log(f"Epoch {epoch + 1} mean {phase} losses: "
                f"{dict((k, round(v, 5)) for k, v in m.items())}")
        history.append(means)

        eval_loss = means["val"].get("total", float("inf"))
        improved = eval_loss < min_loss
        min_loss = min(min_loss, eval_loss)
        # model_last_<e> holds the min_loss of epochs 1..e, so a run resumed
        # from it keeps the best loss so far (the JAX package saves it before
        # this epoch's val loss is counted, and a resumed run there can
        # overwrite model_best with a worse model)
        if (epoch + 1) % save_weight_step == 0:
            save(f"last_{epoch + 1}", net, optimizer, epoch + 1, min_loss)
        if improved:
            save("best", net, optimizer, epoch + 1, min_loss)
            log(f"Best VAL loss so far: {min_loss:.5f}")
    if profile_window is not None:
        profile_window.close()
    save("final", net, optimizer, total_epochs, min_loss)
    board.close()
    return history
