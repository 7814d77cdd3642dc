"""Loss recording and TensorBoard logging (port of
pose2room_tpu/utils/logger.py, reference net_utils/utils.py:296-405),
single process."""


class AverageMeter:
    def __init__(self):
        self.val = 0.0
        self.avg = 0.0
        self.sum = 0.0
        self.count = 0

    def update(self, val, n=1):
        self.val = float(val)
        self.sum += float(val) * n
        self.count += n
        self.avg = self.sum / max(self.count, 1)


class LossRecorder:
    """Running means of each loss term, weighted by the batch size."""

    def __init__(self, batch_size=1):
        self.batch_size = batch_size
        self.loss_recorder = {}

    def update_loss(self, loss_dict):
        for key, value in loss_dict.items():
            self.loss_recorder.setdefault(key, AverageMeter()).update(value, self.batch_size)

    def means(self):
        return {k: m.avg for k, m in self.loss_recorder.items()}


class LogBoard:
    """TensorBoard scalar writer: ``"{key}/{phase}"`` tags at the caller's
    step numbers, in ``logdir`` (default ``runs``, relative to the working
    directory, as the JAX package and the reference write it).  A no-op
    where tensorboard does not import, as in the JAX package."""

    def __init__(self, logdir="runs"):
        self.writer = None
        try:
            from torch.utils.tensorboard import SummaryWriter
        except ImportError:
            return
        self.writer = SummaryWriter(logdir)

    def update(self, value_dict, step, phase):
        if self.writer is None:
            return
        for key, value in value_dict.items():
            self.writer.add_scalar(f"{key}/{phase}", float(value), step)

    def close(self):
        if self.writer is not None:
            self.writer.close()
