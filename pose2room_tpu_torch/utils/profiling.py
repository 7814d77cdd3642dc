"""Profiling: per-step timing, the port's layer spans, and a trace window.

Port of pose2room_tpu/utils/profiling.py and the train engine's
ProfileWindow (pose2room_tpu/train/engine.py:122-144):

* ``StepTimer``: rolling per-step latency on the host clock;
* ``annotate``: a named span at a layer boundary of the port (``SPANS``),
  recorded as ``p2r/<name>`` while a torch profiler is recording and
  nothing otherwise, so the spans sit on the profiler's own clock beside
  the host operations and the card's kernels they enclose;
* ``ProfileWindow``: a torch.profiler trace of train steps
  [start, start + n), opened by ``log.profile_steps > 0`` in the train
  engine, written into ``logdir`` as a ``*.pt.trace.json`` file
  (chrome://tracing, Perfetto, or TensorBoard's profiler plugin).

Tracing is on exactly while a profiler records (a ``ProfileWindow``, or a
caller's own ``torch.profiler.profile``); there is no other switch.
"""

import contextlib
import time

import torch
from torch._C._profiler import _RecordFunctionFast
from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

PREFIX = "p2r/"

# every span of the port and its layer, the layers in the order they run;
# a span nests in the span of the call around it
SPANS = {
    "train/h2d": "train step",  # train/step.py:batch_to_device
    "train/step": "train step",  # train/step.py:train_step: forward and the three below
    "train/loss": "train step",  # models/loss.py:detection_loss
    "train/backward": "train step",  # zero_grad, backward, the tensor-parallel gradient sums
    "train/optimizer": "train step",  # global norm, clipping, the optimizer's step, the global losses
    "train/allreduce": "train step",  # parallel/mesh.py:_sum_hook: a gradient bucket's all-reduce launched
    "model/forward": "model",  # P2RNet.forward
    "model/generate": "model",  # P2RNet.generate
    "model/noise": "model",  # P2RNet.mdn_eps: the host draw and its upload
    "model/backbone": "model",  # the ST-GCN
    "model/vote": "model",  # center votes and their L2 normalisation
    "model/proposal": "model",  # ProposalNet._aggregate: FPS, gather, ball query, aggregation MLP
    "model/heads": "model",  # the rest of ProposalNet.forward
    "agcn/forward": "model",  # AGCN.forward (models/agcn.py)
    "agcn/gcn": "model",  # a unit's adaptive graph convolution, theta / phi to its ReLU
    "agcn/adjacency": "model",  # its theta / phi, scores, softmax and + A + B
    "agcn/tcn": "model",  # a unit's temporal conv, its BN, the residual and the ReLU
}

_OFF = contextlib.nullcontext()


class StepTimer:
    window = 50

    def __init__(self):
        self.times = []
        self._last = None

    def tick(self):
        now = time.perf_counter()
        if self._last is not None:
            self.times.append(now - self._last)
            if len(self.times) > self.window:
                self.times.pop(0)
        self._last = now

    @property
    def mean_ms(self):
        return 1000.0 * sum(self.times) / len(self.times) if self.times else 0.0


def annotate(name):
    """The span ``p2r/<name>`` while a torch profiler records; otherwise one
    shared null context, so an untraced step pays one state check.

    The span is recorded as an operator, not as ``record_function``'s user
    annotation: the profiler credits a kernel to the innermost operator open
    on the thread that launched it, and the port's own kernels are launched
    through ctypes, outside any operator, so only an operator span around
    them counts their device time."""
    if torch._C._autograd._profiler_enabled():
        return _RecordFunctionFast(PREFIX + name)
    return _OFF


class ProfileWindow:
    """Captures a trace of train steps [start_step, start_step + n_steps),
    counted from the run's first step, into ``logdir``."""

    def __init__(self, logdir, start_step, n_steps, cuda=False):
        self.logdir = str(logdir)
        self.start_step = start_step
        self.end_step = start_step + n_steps
        self.cuda = cuda
        self._prof = None
        self._done = False

    def maybe_start(self, step):
        """Call before a step, with the number of steps done so far."""
        if not self._done and self._prof is None and step >= self.start_step:
            activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if self.cuda else [])
            self._prof = profile(activities=activities, on_trace_ready=tensorboard_trace_handler(self.logdir))
            self._prof.start()

    def maybe_stop(self, step):
        """Call after a step, with the number of steps done so far; the
        trace is written when the window's last step is done."""
        if self._prof is not None and step >= self.end_step:
            if self.cuda:
                torch.cuda.synchronize()
            self._prof.stop()
            self._prof = None
            self._done = True

    def close(self):
        """Write what was captured if the run ended inside the window."""
        if self._prof is not None:
            self.maybe_stop(self.end_step)
