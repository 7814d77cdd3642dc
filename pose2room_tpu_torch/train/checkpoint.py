"""Checkpoints of the train path (the reference CheckpointIO's save,
net_utils/utils.py:21-110).

``save(suffix, ...)`` writes ``<run_dir>/model_<suffix>.pth`` with
``torch.save``: {"net": the model's state_dict in the reference layout,
"optimizer": the optimizer's state_dict, "epoch", "min_loss"}.  The demo
runner loads "net" with ``finetune: True``.  Resume and finetune of a
training run are not ported.
"""

import os

import torch


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
