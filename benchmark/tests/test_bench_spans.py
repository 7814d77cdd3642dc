"""The reduction of the program's own spans (harness/spans.py), and the
traced window's reduction (harness/trace.py) on a fixed event list that
holds such spans (CPU)."""

import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from benchmark.harness import spans
from benchmark.harness import trace as tr

MAIN, LOADER = 1, 2
# (name, is_device, start_us, end_us, thread): a window of one step whose
# idle gaps fall inside the program's spans, and device work that crosses
# its ends
EVENTS = [
    ("bench/window", False, 1000, 2000, MAIN),
    ("bench/step", False, 1010, 1500, MAIN),
    ("p2r/train/step", False, 1020, 1490, MAIN),
    ("aten::mm", False, 1030, 1040, MAIN),
    ("cudaLaunchKernel", False, 1035, 1039, MAIN),
    ("p2r/model/noise", False, 1100, 1200, MAIN),
    ("aten::normal_", False, 1110, 1190, MAIN),
    ("aten::to", False, 1192, 1290, MAIN),
    ("bench/read_losses", False, 1500, 1600, MAIN),
    ("aten::_local_scalar_dense", False, 1510, 1590, MAIN),
    ("sgemm_kernel", True, 1040, 1090, 0),
    ("sgemm_kernel", True, 1300, 1400, 0),
    ("Memcpy HtoD (Pageable -> Device)", True, 1395, 1420, 0),
    ("elementwise_kernel", True, 1950, 2050, 0),
    ("sgemm_kernel", True, 900, 990, 0),
]
# a loader thread's operations, started after the main thread's, running
# at the midpoints of a gap inside the noise span and of one outside any span
LOADER_EVENTS = [
    ("aten::copy_", False, 1194, 1260, LOADER),
    ("aten::stack", False, 1600, 1800, LOADER),
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


@pytest.mark.parametrize("loader", [False, True], ids=["main-thread", "loader-thread-overlaps"])
def test_reduce_events_names_the_program_span_in_an_idle_gap(loader):
    """The traced window's reduction, pinned on a fixed event list: an idle
    gap names the main thread's innermost harness span, innermost program
    span and running operation; a loader thread's operations, though they
    started later, name no gap."""
    assert tr.reduce_events(EVENTS + (LOADER_EVENTS if loader else [])) == {
        "busy_s": pytest.approx(220e-6),
        "window_s": pytest.approx(1e-3),
        "kernels": {"sgemm_kernel": [2, pytest.approx(150e-6)],
                    "Memcpy HtoD (Pageable -> Device)": [1, pytest.approx(25e-6)],
                    "elementwise_kernel": [1, pytest.approx(50e-6)]},
        "breakdown": {
            "device_ops": [["sgemm_kernel", pytest.approx(150e-6)], ["elementwise_kernel", pytest.approx(50e-6)],
                           ["Memcpy HtoD (Pageable -> Device)", pytest.approx(25e-6)]],
            "idle_gaps": [["none: none", pytest.approx(530e-6)],
                          ["step: p2r/model/noise: aten::to", pytest.approx(210e-6)],
                          ["step: p2r/train/step: none", pytest.approx(40e-6)]],
        },
    }


def test_reduce_events_names_a_gap_deep_in_a_long_span():
    """A program span that holds more operations than the look back over
    operations still names a gap near its end."""
    events = [("bench/window", False, 0, 10000, MAIN), ("p2r/train/backward", False, 100, 9000, MAIN)]
    events += [("aten::mul", False, 200 + 10 * k, 205 + 10 * k, MAIN) for k in range(300)]
    events += [("sgemm_kernel", True, 0, 100, 0), ("sgemm_kernel", True, 9500, 10000, 0)]
    assert tr.reduce_events(events)["breakdown"]["idle_gaps"] == [
        ["none: p2r/train/backward: none", pytest.approx(9400e-6)]]
