"""Checkpoints of the train path: save, resume and finetune.

Port of pose2room_tpu/train/checkpoint.py (the reference CheckpointIO,
net_utils/utils.py:21-203):

* ``save(suffix, ...)`` writes ``<run_dir>/model_<suffix>.pth`` with
  ``torch.save``: {"net": the model's state_dict in the reference layout
  (BatchNorm running statistics included), "optimizer": the optimizer's
  state_dict (AdamW's per-parameter ``step``, ``exp_avg``, ``exp_avg_sq``
  and the param groups), "epoch", "min_loss"};
* ``find_resume_checkpoint`` scans the sibling run dirs of this one newest
  first for a ``model_last*`` checkpoint, and ``load_into_state`` restores
  all of it (``resume: True``);
* ``load_weights`` merges a checkpoint's weights partially into the model
  (``finetune: True``): each tensor whose key and shape match, each skip
  logged (``convert.load_partial_state_dict``).

The JAX package downloads an http(s) ``weight:``; this port downloads
nothing and raises for one.
"""

import os
import re

import torch

from pose2room_tpu_torch.convert import load_partial_state_dict

_LAST = re.compile(r"model_last(?:_(\d+))?(?:\.pth)?$")


def _epoch_of(name):
    """``model_last_<k>[.pth]`` -> k; a bare ``model_last[.pth]`` -> -1."""
    m = _LAST.match(name)
    return int(m.group(1)) if m and m.group(1) is not None else -1


class CheckpointIO:
    def __init__(self, run_dir, log_fn=print):
        self.run_dir = os.path.abspath(run_dir)
        self.log = log_fn

    def path(self, suffix):
        return os.path.join(self.run_dir, f"model_{suffix}.pth")

    def save(self, suffix, model, optimizer, epoch, min_loss):
        path = self.path(suffix)
        torch.save({
            "net": model.state_dict(),
            "optimizer": optimizer.state_dict(),
            "epoch": int(epoch),
            "min_loss": float(min_loss),
        }, path)
        self.log(f"Saved checkpoint {path}")
        return path

    def find_resume_checkpoint(self):
        """The newest ``model_last*`` under the sibling run dirs, or None.

        Run dirs are ISO timestamps, scanned newest first; within the newest
        that has any, the highest ``model_last_<k>`` wins (a bare
        ``model_last`` counts as epoch -1)."""
        parent = os.path.dirname(self.run_dir)
        if not os.path.isdir(parent):
            return None
        for d in sorted(os.listdir(parent), reverse=True):
            full = os.path.join(parent, d)
            if not os.path.isdir(full):
                continue
            candidates = [name for name in os.listdir(full) if name.startswith("model_last")]
            if candidates:
                return os.path.join(full, max(candidates, key=_epoch_of))
        return None

    @staticmethod
    def load_into_state(path, model, optimizer):
        """Resume: restore the model's state_dict (weights and BatchNorm
        running statistics) and the optimizer's state in place.  Returns
        (epoch, min_loss) of the checkpoint."""
        ckpt = torch.load(path, map_location="cpu", weights_only=True)
        model.load_state_dict(ckpt["net"], strict=True)
        optimizer.load_state_dict(ckpt["optimizer"])
        return int(ckpt["epoch"]), float(ckpt["min_loss"])

    def load_weights(self, path, model):
        """Finetune: merge the checkpoint's weights and running statistics
        into ``model`` partially (reference or port layout; a checkpoint
        dict with "net", or a bare state_dict).  Returns the number of
        tensors loaded."""
        if str(path).startswith(("http://", "https://")):
            raise NotImplementedError(
                f"weight {path}: downloading weights is not ported (the port reads local "
                "checkpoints only); fetch the file and give its path")
        ckpt = torch.load(path, map_location="cpu", weights_only=True)
        return load_partial_state_dict(model, ckpt.get("net", ckpt), log=self.log)
