"""The reduction of the program's own spans (harness/spans.py), and the
traced window's reduction (harness/trace.py) on a fixed event list that
holds such spans (CPU)."""

import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from benchmark.harness import spans
from benchmark.harness import trace as tr

# (name, is_device, start_us, end_us): a window of one step whose idle gaps
# fall inside the program's spans, and device work that crosses its ends
EVENTS = [
    ("bench/window", False, 1000, 2000),
    ("bench/step", False, 1010, 1500),
    ("p2r/train/step", False, 1020, 1490),
    ("aten::mm", False, 1030, 1040),
    ("cudaLaunchKernel", False, 1035, 1039),
    ("p2r/model/noise", False, 1100, 1200),
    ("aten::normal_", False, 1110, 1190),
    ("bench/read_losses", False, 1500, 1600),
    ("aten::_local_scalar_dense", False, 1510, 1590),
    ("sgemm_kernel", True, 1040, 1090),
    ("sgemm_kernel", True, 1300, 1400),
    ("Memcpy HtoD (Pageable -> Device)", True, 1395, 1420),
    ("elementwise_kernel", True, 1950, 2050),
    ("sgemm_kernel", True, 900, 990),
]


def test_reduce_spans_counts_host_and_device_seconds_inside_the_window():
    events = [
        ("p2r/train/step", 900, 1400, 300.0),  # starts before the window: host time clipped
        ("p2r/train/step", 1500, 2100, 400.0),  # ends after it
        ("p2r/model/backbone", 1100, 1300, 250.0),
        ("p2r/model/backbone", 1600, 1700, 0.0),
        ("p2r/model/noise", 2000, 2300, 50.0),  # outside: left out
        ("p2r/model/vote", 500, 1000, 50.0),  # ends where the window starts: left out
    ]
    got = spans.reduce_spans(events, (1000, 2000))
    assert set(got) == {"p2r/train/step", "p2r/model/backbone"}
    assert got["p2r/train/step"]["count"] == 2
    assert got["p2r/train/step"]["host_s"] == pytest.approx(900e-6)
    assert got["p2r/train/step"]["device_s"] == pytest.approx(700e-6)
    assert got["p2r/model/backbone"] == pytest.approx({"count": 2, "host_s": 300e-6, "device_s": 250e-6})


def test_program_reads_the_spans_of_a_profiled_window():
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function("p2r/model/noise"):  # before the window
            torch.arange(4.0).sum()
        with record_function(tr.WINDOW_SPAN):
            for _ in range(3):
                with record_function("p2r/train/step"):
                    with record_function("p2r/model/noise"):
                        torch.randn(64, 64).sum()
            with record_function("bench/step"):
                torch.arange(4.0).sum()
    got = spans.program(prof)
    assert set(got) == {"p2r/train/step", "p2r/model/noise"}
    assert got["p2r/train/step"]["count"] == got["p2r/model/noise"]["count"] == 3
    assert got["p2r/train/step"]["host_s"] >= got["p2r/model/noise"]["host_s"] > 0
    assert got["p2r/train/step"]["device_s"] == got["p2r/model/noise"]["device_s"] == 0  # no card


def test_reduce_events_names_the_program_span_in_an_idle_gap():
    """The traced window's reduction, pinned on a fixed event list: the
    program's spans are host events there, so an idle gap inside one names
    it where no operation runs."""
    assert tr.reduce_events(EVENTS) == {
        "busy_s": pytest.approx(220e-6),
        "window_s": pytest.approx(1e-3),
        "kernels": {"sgemm_kernel": [2, pytest.approx(150e-6)],
                    "Memcpy HtoD (Pageable -> Device)": [1, pytest.approx(25e-6)],
                    "elementwise_kernel": [1, pytest.approx(50e-6)]},
        "breakdown": {
            "device_ops": [["sgemm_kernel", pytest.approx(150e-6)], ["elementwise_kernel", pytest.approx(50e-6)],
                           ["Memcpy HtoD (Pageable -> Device)", pytest.approx(25e-6)]],
            "idle_gaps": [["none: none", pytest.approx(530e-6)], ["step: p2r/model/noise", pytest.approx(210e-6)],
                          ["step: p2r/train/step", pytest.approx(40e-6)]],
        },
    }
