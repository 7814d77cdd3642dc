"""The plain reference against the program at a tiny size on the CPU, on
the benchmark's own weights and inputs."""

import numpy as np
import pytest
import torch

from benchmark.harness import cells, checks, spec
from benchmark.reference import p2rnet as ref_model
from benchmark.reference.graph import spatial_graph
from benchmark.reference.loss import detection_loss
from pose2room_tpu_torch.models.graph import build_spatial_graph
from pose2room_tpu_torch.models.loss import detection_loss as port_loss


def test_graph_as_published():
    assert np.array_equal(spatial_graph(), build_spatial_graph())


def test_weights_load_into_both_sides(tiny_root):
    cell = spec.load_cell(tiny_root, "tiny-generate-cell")
    g = cells.traffic_of(cell, 7, torch.device("cpu"))
    assert set(g.weights) == set(g.model.state_dict())
    for k, v in g.model.state_dict().items():
        assert torch.equal(v, g.weights[k]), k


def test_generate_matches_the_program(tiny_root):
    cell = spec.load_cell(tiny_root, "tiny-generate-cell")
    g = cells.traffic_of(cell, 11, torch.device("cpu"))
    clips = g.pool[:g.batch]
    with torch.no_grad():
        ep = g.model.generate(clips, folded=g.folded)
    out = {k: ep[k] for k in checks.KEPT}
    own = checks.reference_outputs(cell.config["model"], g.weights, clips, torch.device("cpu"))
    # the reference's own choices are the program's at this size
    for k in ("seed_inds", "aggregated_vote_inds"):
        assert torch.equal(own[k].long(), out[k].long()), k
    nums = checks.generate_numbers(cell.config["model"], g.weights, clips, out, torch.device("cpu"))
    assert nums["seed_gap"] == 0 and nums["fps_gap"] == 0 and nums["ball_gap"] == 0
    assert nums["vote_gap"] < 1e-4 and nums["box_gap"] < 1e-4, nums


def test_train_step_matches_the_program(tiny_root):
    """One train step: the program's loader batch equals the batch worked
    out again, the losses and gradients agree."""
    cell = spec.load_cell(tiny_root, "tiny-train-cell")
    dev = torch.device("cpu")
    t = cells.traffic_of(cell, 13, dev)
    batch, losses, ep_p = t.step()
    grads = {n: p.grad.clone() for n, p in t.model.named_parameters()}
    t.close()
    m = cell.config["model"]
    want = t.checked_inputs(1)[0][0]
    assert checks.batch_gap({k: np.asarray(batch[k]) for k in want}, want) == 0.0
    ref = checks.build_reference(m, t.weights0, dev).train()
    gt = {k: torch.from_numpy(v) for k, v in want.items()}
    eps = checks.step_noise(m, t.batch, t.noise_seed(0), dev)
    ep = ref(gt["input_joints"], eps=eps)
    assert torch.equal(ep["aggregated_vote_inds"], ep_p["aggregated_vote_inds"].long())
    ref_losses = detection_loss(ep, gt)
    got = port_loss(ep_p, {k: torch.from_numpy(v) for k, v in want.items()})
    for k, v in ref_losses.items():
        assert abs(got[k].item() - v.item()) <= 1e-5 * max(1.0, abs(v.item())), k
    assert abs(losses["total"].item() - ref_losses["total"].item()) <= 1e-5 * ref_losses["total"].item()
    ref_losses["total"].backward()
    ref_grads = {n: p.grad for n, p in ref.named_parameters()}
    assert set(ref_grads) == set(grads)
    # f32 gradients through live BatchNorm at batch 2 part by ~1e-3 of a
    # leaf's entries; the norms of the leaves agree far closer
    assert max(checks.leaf_gaps(grads, ref_grads, list(grads)).values()) < 1e-2


def test_noise_is_the_programs_draw():
    m = {"num_proposals": 16, "num_gaussian": 10}
    a = ref_model.mdn_noise(2, 16, 10, torch.Generator().manual_seed(5))
    from pose2room_tpu_torch.models.p2rnet import P2RNet, P2RNetConfig

    net = P2RNet(P2RNetConfig(num_frames=96, num_seeds=64, num_proposals=16, num_gaussian=10), device="cpu")
    b = net.mdn_eps(2, torch.Generator().manual_seed(5))
    assert all(torch.equal(a[k], b[k]) for k in a) and list(a) == list(b)
    assert checks.step_noise(dict(m), 2, 5, torch.device("cpu"))["size"].shape == (2, 16, 10, 1, 3)


def _near_tie_points():
    """Points (x, 1, z): 0 the first pick; 1 and 2 near-tied as the furthest
    from it (2 a hair further), 5.2 m apart; 3 far from both; 4 near 1.
    FPS that takes 1 before 2 picks 0, 1, 3, 2."""
    th, r = np.radians(30.0), 10.0000001
    pts = [(0.0, 0.0), (10.0, 0.0), (r * np.cos(th), r * np.sin(th)), (-9.0, 0.0), (9.0, -4.0)]
    return torch.tensor([[(x, 1.0, z) for x, z in pts]], dtype=torch.float64)


@pytest.mark.parametrize("picks, low, high", [
    # the near tie taken the other way: greedy replay (2 first) leaves point
    # 4 far from every pick and reads 54 m^2; some order reads ~2e-6
    ([0, 1, 2, 3], 0.0, 1e-5),
    # point 4 in place of 2: a wrong pick, 26.8 - 17 m^2 short of the best
    ([0, 1, 3, 4], 9.0, 10.0),
])
def test_fps_gap_takes_the_order_that_a_near_tie_allows(picks, low, high):
    xyz, sel = _near_tie_points(), torch.tensor([picks])
    assert float(checks._greedy_order_gap(xyz, sel).max()) > 9.0
    assert low <= checks.fps_gap(xyz, sel) <= high
