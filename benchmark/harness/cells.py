"""One run of a cell, and what the traffic kinds share.

A traffic mix (benchmark/traffic/<name>.json) names its ``kind``; the
loop of that kind is ``Traffic`` in benchmark/kinds/<kind>.py, found by
name (``spec.kind``), and drives the program's own entry points in a
closed loop with one client.  A kind's ``Traffic(cell, seed, device)``
makes its inputs and the program's state from the seed and offers
``warm()``, ``window(seconds)``, ``traced()``, ``finish()``, ``close()``
and ``numbers()`` (the comparison, once the program's state is freed),
and the attributes ``batch`` and, where it has them, ``waits`` (seconds
each iteration waited for its input) and ``loader_stats`` (its input
loader's counters over the traced iterations).  A kind whose model is not
P2RNet offers ``shape()``: the shapes its counts and MFU read, in place of
``work.shape_of`` of the configuration's ``model``.

Everything random comes from ``--seed`` through ``streams``; every seed
gives the same sizes.
"""

import time

import numpy as np
import torch
from torch.profiler import record_function

from benchmark.harness import spans, spec, work
from benchmark.harness import trace as tr
from pose2room_tpu_torch import kernels
from pose2room_tpu_torch.models.p2rnet import P2RNet, P2RNetConfig


def streams(seed):
    """Independent sub-seeds of a run's seed (any integer)."""
    s = np.random.SeedSequence(seed % 2 ** 64).generate_state(5, dtype=np.uint64)
    return {"scenes": int(s[0] % 2 ** 32), "weights": int(s[1] % 2 ** 63),
            # the loader seeds its epochs with seed * 7919 + epoch, under 2**32
            "loader": int(s[2] % 500_000), "noise": int(s[3] % 2 ** 62), "sample": int(s[4] % 2 ** 32)}


def port_config(model):
    return P2RNetConfig(
        num_frames=model["num_frames"], num_seeds=model["num_seeds"], num_proposals=model["num_proposals"],
        num_gaussian=model["num_gaussian"], num_class=model["num_class"], num_joints=model["num_joints"],
        compute_dtype=model["compute_dtype"], sparse_eval=model["sparse_eval"])


def span(name):
    return record_function(tr.SPAN_PREFIX + name)


def sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def program_model(model_cfg, weights, device):
    model = P2RNet(port_config(model_cfg), device=device)
    model.load_state_dict(weights, strict=True)
    return model


def traffic_of(cell, seed, device):
    """The cell's traffic: the ``Traffic`` of its mix's kind, made from the seed."""
    return spec.kind(cell.root, cell.traffic["kind"]).Traffic(cell, seed, device)


def trace_window(traffic, device):
    """The traffic's ``traced`` iterations under torch.profiler, reduced:
    the device's operations (``harness/trace.py``) and, under ``program``,
    the program's own spans (``harness/spans.py``)."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if device.type == "cuda" else [])
    with profile(activities=acts) as prof:
        with record_function(tr.WINDOW_SPAN):
            n = traffic.traced()
            traffic.finish()
    out = tr.reduce_events(tr.profiler_events(prof))
    out["iterations"] = n
    out["program"] = spans.program(prof)
    return out


def run(cell, seed, seconds, trace, device, t_start):
    """One run of a cell: set-up, the window, the traced window with
    ``trace``, then the comparison.  Returns the context the metric
    readers take, with the comparison's 'numbers', 'attempted' and the
    memory peak."""
    phases = {"imports": time.perf_counter() - t_start}
    if device.type == "cuda":
        kernels.timed_build()
        torch.zeros(1, device=device)
    phases["card_and_kernels"] = time.perf_counter() - t_start - sum(phases.values())
    traffic = traffic_of(cell, seed, device)
    phases["inputs_weights_model"] = time.perf_counter() - t_start - sum(phases.values())
    traffic.warm()
    sync(device)
    phases["first_steps"] = time.perf_counter() - t_start - sum(phases.values())
    setup_s = time.perf_counter() - t_start
    window = traffic.window(seconds)
    traced = trace_window(traffic, device) if trace else None
    waits = list(getattr(traffic, "waits", []))
    shape = traffic.shape() if hasattr(traffic, "shape") else work.shape_of(cell.config["model"], traffic.batch)
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    traffic.close()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    numbers = traffic.numbers()
    return {
        "root": cell.root, "cell": cell, "setup_s": setup_s, "setup_phases": phases, "window": window,
        "trace": traced, "spans": {"loader_wait": waits, "loader": getattr(traffic, "loader_stats", None)},
        "numbers": numbers, "attempted": window["items"], "memory_peak_bytes": int(peak), "shape": shape,
    }
