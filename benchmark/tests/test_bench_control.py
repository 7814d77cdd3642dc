"""The control on the card: the plain reference put in the program's
place and computed with TF32 on (the precision below the configuration's
f32), at each cell's own size, on three seeds, comes out not correct by
the cell's limits; so do the planted faults of half the batch left out of
a train step and of a train step whose update goes up the gradient.  Needs the card: ``python -m pytest benchmark/tests -m
gpu -q``."""

import os

import pytest

from benchmark import calibrate
from benchmark.harness import checks, spec

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
pytestmark = pytest.mark.gpu
SEEDS = (2_147_483_659, 3_000_000_019, 21)


@pytest.mark.parametrize("workload", ["generate-b32", "sparse-generate-b32", "train-b8"])
@pytest.mark.parametrize("seed", SEEDS)
def test_control_is_not_correct(cuda_device, workload, seed):
    cell = spec.load_cell(ROOT, workload)
    ok, compared = checks.judge(calibrate.control_numbers(cell, seed, cuda_device), cell.limits)
    assert not ok, compared


@pytest.mark.parametrize("seed", SEEDS)
def test_train_half_batch_is_not_correct(cuda_device, seed):
    cell = spec.load_cell(ROOT, "train-b8")
    ok, compared = checks.judge(calibrate.control_numbers(cell, seed, cuda_device, half=True), cell.limits)
    assert not ok, compared


@pytest.mark.parametrize("seed", SEEDS)
def test_train_ascent_is_not_correct(cuda_device, seed):
    """The program's own step with every update applied with the wrong sign
    (the learning rate negated): only the change's direction shows it."""
    cell = spec.load_cell(ROOT, "train-b8")
    nums = calibrate.program_numbers(cell, seed, 1.0, cuda_device, fault="ascent")
    ok, compared = checks.judge(nums, cell.limits)
    assert not ok and compared["update_cos"]["value"] > compared["update_cos"]["limit"], compared
