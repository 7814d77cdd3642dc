"""Profiling: torch.profiler trace capture and per-step timing.

Port of pose2room_tpu/utils/profiling.py and the train engine's
ProfileWindow (pose2room_tpu/train/engine.py:122-144):

* ``StepTimer``: rolling per-step latency on the host clock;
* ``trace``: a context manager that captures a torch.profiler trace (host
  ops, and the card's kernels where there is a card) into ``logdir`` as a
  ``*.pt.trace.json`` file (chrome://tracing, Perfetto, or TensorBoard's
  profiler plugin);
* ``ProfileWindow``: the same capture over train steps [start, start + n),
  opened by ``log.profile_steps > 0`` in the train engine;
* ``annotate``: a named span inside a trace (``record_function``).
"""

import contextlib
import time

import torch
from torch.profiler import ProfilerActivity, profile, record_function, tensorboard_trace_handler


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


def _profiler(logdir, cuda):
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    return profile(activities=activities, on_trace_ready=tensorboard_trace_handler(str(logdir)))


@contextlib.contextmanager
def trace(logdir):
    """Capture a torch.profiler trace into ``logdir`` while the block runs,
    the card's kernels too where there is a card."""
    prof = _profiler(logdir, torch.cuda.is_available())
    prof.start()
    try:
        yield
    finally:
        prof.stop()


def annotate(name):
    """Named span inside a trace."""
    return record_function(name)


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
            self._prof = _profiler(self.logdir, self.cuda)
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
