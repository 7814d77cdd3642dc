"""The comparison that decides ``correct``: what the timed path produced,
against the plain reference (benchmark/reference) on the same inputs and
weights, number by number, each against its limit.

Discrete choices (seed frames, FPS picks, ball membership) are judged by a
tie-aware gap, worked out in float64 from the reference's own values: how
far the program's choice lies from the best one.  A choice that rounding
can flip reads near 0; a wrong one reads the size of the step it skipped.
The reference then follows the program's choices (``follow``), so the
continuous outputs downstream compare like for like.

Generate cells: ``seed_gap`` (m), ``vote_gap`` (m), ``fps_gap`` (m^2),
``ball_gap`` (m^2), ``box_gap`` (widest gap of the box heads' outputs over
the largest reference value of that output).  Train cells, over the
first three steps of the window's own step function: ``batch_gap`` (the
loader's batch against the batch recomputed from the scenes),
``seed_gap``, ``vote_gap``, ``fps_gap``, ``ball_gap`` (the first step),
``loss1_gap`` .. ``loss3_gap`` (each step's loss, relative), ``grad_gap``
(the first step's gradient as the optimizer holds it, worst leaf: the gap
of the leaf's norms over the larger of the reference leaf's norm and the
median leaf's) and ``update_gap`` (the parameters' change over the three
steps, the same measure, over the leaves whose reference gradient is at
least a thousandth of the median leaf's) and ``update_cos`` (the same
change's direction over the same leaves: the worst leaf's 1 - cos of the
angle between the program's change and the reference's; an update with
the wrong sign reads near 2, entries permuted near 1).  A cell's limits
file names the numbers it compares; the rest are readings for
``calibrate.py``.
"""

import numpy as np
import torch

from benchmark.reference import p2rnet as ref_model
from benchmark.reference.loss import detection_loss

NO_CHOICE = 1e10  # the gap of a pick the program could not have made
CHOICE_OUTPUTS = ("seed_inds", "vote_xyz", "aggregated_vote_inds")
BOX_KEYS = ("center", "size", "heading", "sem_cls_scores", "objectness_scores")
KEPT = CHOICE_OUTPUTS + BOX_KEYS  # the outputs a generate batch copies back


def _reference(m):
    return ref_model.P2RNet(num_frames=m["num_frames"], num_seeds=m["num_seeds"],
                            num_proposals=m["num_proposals"], num_gaussian=m["num_gaussian"],
                            num_class=m["num_class"], num_joints=m["num_joints"],
                            channels=m["channels"], max_hop=m["max_hop"])


def build_reference(model_cfg, weights, device):
    ref = _reference(model_cfg).to(device)
    ref.load_state_dict({k: v.to(device) for k, v in weights.items()}, strict=True)
    return ref


def shapes(model_cfg):
    """{name: shape} of every leaf the weights hold, and the mixture grids."""
    with torch.device("meta"):
        ref = _reference(model_cfg)
    return {k: tuple(v.shape) for k, v in ref.state_dict().items()}, ref.mdn_mu_init()


def seed_gap(joints, seed_inds, n_seeds):
    """Widest gap, in metres of path, of the program's seed frames above
    the nearest frame to each arc-length target."""
    _, cost = ref_model.seed_frames(joints[:, :, 0], n_seeds)
    got = cost.gather(1, seed_inds.long().to(cost.device)[:, None, :])[:, 0]
    return float((got - cost.amin(1)).max())


def fps_gap(xyz, picks):
    """Widest gap, in m^2, between the furthest remaining point and the
    furthest point of the program's pick set, replaying FPS over ``xyz``
    (float64) in the order that keeps it least.  The set is sorted, so
    its order is rebuilt: first greedily, the set's furthest point at each
    step; where that leaves a gap, by a search over the orders that near
    ties allow (``_least_order_gap``), since two near-tied picks taken the
    other way round leave the points near the one taken later far from
    every pick until it is taken.  A set that FPS could have picked up to
    near ties reads near 0, a wrong pick the size of the step it skipped."""
    xyz = xyz.double()
    picks = picks.long().to(xyz.device)
    greedy = _greedy_order_gap(xyz, picks)
    worst = 0.0
    for r in torch.argsort(greedy, descending=True).tolist():
        g = float(greedy[r])
        if g <= worst:
            break
        if g >= NO_CHOICE:
            return g
        worst = max(worst, _least_order_gap(xyz[r].cpu().numpy(), picks[r].cpu().numpy(), g, worst))
    return worst


def _greedy_order_gap(xyz, picks):
    """(B,) the gap of each row with the set's order rebuilt greedily."""
    B, N, _ = xyz.shape
    rows = torch.arange(B, device=xyz.device)
    in_set = torch.zeros(B, N, dtype=torch.bool, device=xyz.device)
    in_set[rows[:, None], picks] = True
    valid = (xyz * xyz).sum(-1) > ref_model.NEAR_ORIGIN_SQ
    picked = torch.zeros_like(in_set)
    picked[:, 0] = True
    gap = torch.where(in_set[:, 0], 0.0, NO_CHOICE).to(xyz.dtype)
    mind = torch.full((B, N), 1e10, dtype=xyz.dtype, device=xyz.device)
    last = torch.zeros(B, dtype=torch.long, device=xyz.device)
    for _ in range(picks.shape[1] - 1):
        d = ((xyz - xyz[rows, last][:, None]) ** 2).sum(-1)
        mind = torch.where(valid, torch.minimum(mind, d), mind)
        score = torch.where(valid, mind, torch.full_like(mind, -1.0))
        best = torch.where(picked, torch.full_like(score, -2.0), score).amax(1)
        mine = torch.where(in_set & ~picked, score, torch.full_like(score, -NO_CHOICE))
        last = mine.argmax(1)
        gap = torch.maximum(gap, best - mine[rows, last])
        picked[rows, last] = True
    return gap


ORDER_SEARCH_NODES = 20_000  # picks tried a threshold, past which it counts as not met


def _least_order_gap(xyz, picks, greedy, floor):
    """The least gap of one row over the orders of its set, as far as it
    matters above ``floor``: for thresholds rising tenfold from 1e-12 m^2,
    a depth-first search, the set's furthest point first, among the set's
    points within the threshold of the furthest remaining point; the first
    order found gives its own widest gap.  ``greedy`` (that of the greedy
    order) where none is found below it.  xyz (N, 3) float64, picks (P,)."""
    N = xyz.shape[0]
    valid = (xyz * xyz).sum(-1) > ref_model.NEAR_ORIGIN_SQ
    in_set = np.zeros(N, dtype=bool)
    in_set[picks] = True
    steps = picks.shape[0] - 1
    thresholds = [floor] if floor > 0 else []
    thresholds += [t for t in 10.0 ** np.arange(-12, 1) if max(floor, 0.0) < t < greedy]
    for t in thresholds:
        failed, nodes = set(), [0]

        def search(last, mind, picked, gap, depth):
            if depth == steps:
                return gap
            mind = np.where(valid, np.minimum(mind, ((xyz - xyz[last]) ** 2).sum(-1)), mind)
            score = np.where(valid, mind, -1.0)
            best = np.where(picked, -2.0, score).max()
            cand = np.flatnonzero(in_set & ~picked & (score >= best - t))
            for c in cand[np.argsort(-score[cand], kind="stable")]:
                nodes[0] += 1
                if nodes[0] > ORDER_SEARCH_NODES:
                    return None
                picked[c] = True
                key = np.packbits(picked).tobytes()
                if key not in failed:
                    found = search(c, mind, picked, max(gap, best - score[c]), depth + 1)
                    if found is not None:
                        return found
                    if nodes[0] > ORDER_SEARCH_NODES:
                        return None
                    failed.add(key)
                picked[c] = False
            return None

        picked = np.zeros(N, dtype=bool)
        picked[0] = True
        found = search(0, np.full(N, 1e10), picked, 0.0, 0)
        if found is not None:
            return found
    return greedy


def ball_gap(ref_xyz, prog_xyz, picks):
    """Widest |d^2 - r^2| (m^2, the reference's distances) of a point whose
    membership in a ball differs between the program's votes and the
    reference's, over the scan prefix that decides the ball's samples."""
    idx = picks.long()
    hits_p = ref_model.ball_hits(ref_model.take(prog_xyz, idx), prog_xyz)
    c = ref_model.take(ref_xyz, idx).double()
    d2 = ((c[:, :, None] - ref_xyz.double()[:, None]) ** 2).sum(-1)
    r2 = ref_model.RADIUS * ref_model.RADIUS
    hits_r = d2 < r2
    N = d2.shape[-1]

    def decided(h):  # scan positions up to the NSAMPLE-th hit (all when fewer)
        filled = torch.cumsum(h.long(), -1) >= ref_model.NSAMPLE
        return torch.where(filled.any(-1), filled.float().argmax(-1), N - 1)

    upto = torch.maximum(decided(hits_p), decided(hits_r))
    scope = torch.arange(N, device=d2.device) <= upto[..., None]
    differ = (hits_p != hits_r) & scope
    return float(torch.where(differ, (d2 - r2).abs(), torch.zeros_like(d2)).max())


def rel_gap(got, want):
    want = want.float()
    return float((got.float().to(want.device) - want).abs().max() / want.abs().max().clamp(min=1e-30))


def generate_numbers(model_cfg, weights, clips, out, device):
    """The numbers of a generate cell for one batch: ``clips`` (B, T, V, 3)
    the inputs, ``out`` the program's outputs of that batch (host)."""
    x = clips.to(device)
    if not rows_match(out, x.shape[0]):
        return dict.fromkeys(CHOICE_KEYS + ("box_gap",), NO_CHOICE)
    ref = build_reference(model_cfg, weights, device).eval()
    follow = {"seed_inds": out["seed_inds"].to(device), "fps_inds": out["aggregated_vote_inds"].to(device),
              "ball_xyz": out["vote_xyz"].to(device)}
    with torch.no_grad():
        ep = ref(x, follow=follow)
        nums = choice_numbers(x, follow, ep["vote_xyz"], model_cfg)
        nums["box_gap"] = max(rel_gap(out[k], ep[k]) for k in BOX_KEYS)
    return nums


def reference_outputs(model_cfg, weights, clips, device):
    """The reference's own outputs on ``clips`` (no choice followed), in the
    layout the window keeps: the control, put in the program's place."""
    ref = build_reference(model_cfg, weights, device).eval()
    with torch.no_grad():
        ep = ref(clips.to(device))
    return {k: ep[k].cpu() for k in KEPT}


def leaf_gaps(prog, ref, names):
    """{leaf: |‖prog‖ - ‖ref‖| over max(‖ref‖, the median leaf's)}."""
    pn = {n: float(torch.linalg.vector_norm(prog[n].double())) for n in names}
    rn = {n: float(torch.linalg.vector_norm(ref[n].double())) for n in names}
    med = float(np.median(list(rn.values())))
    return {n: abs(pn[n] - rn[n]) / max(rn[n], med, 1e-30) for n in names}


def leaf_cos_gaps(prog, ref, names):
    """{leaf: 1 - cos of the angle between ``prog[leaf]`` and ``ref[leaf]``}
    in float64; a leaf that is all zeros on either side reads 1."""
    out = {}
    for n in names:
        p, r = prog[n].double().flatten(), ref[n].double().flatten()
        den = float(torch.linalg.vector_norm(p)) * float(torch.linalg.vector_norm(r))
        out[n] = 1.0 - (float(p @ r) / den if den > 0 else 0.0)
    return out


def batch_gap(got, want):
    return max(float(np.abs(got[k].astype(np.float64) - want[k].astype(np.float64)).max()) for k in want)


def train_numbers(model_cfg, optim_cfg, weights0, record, batches, noise_seeds, device):
    """The numbers of a train cell.  ``record``: the program's first steps
    ({"batches", "end_points", "losses"} per step, "grad1", "params3"),
    ``batches``: the same steps' batches recomputed from the scenes,
    ``noise_seeds``: each step's MDN noise generator seed.  The choices are
    judged at the first step, where both sides start from the same
    weights; later steps follow the program's choices unjudged, and their
    losses and the parameters' change compare the steps."""
    ref = build_reference(model_cfg, weights0, device).train()
    opt = adam(ref, optim_cfg)
    nums = {"batch_gap": max(batch_gap(r, b) for r, b in zip(record["batches"], batches))}
    loss_gaps, grads = [], None
    m = model_cfg
    for step, (batch, ep_p, loss_p) in enumerate(zip(batches, record["end_points"], record["losses"])):
        gt = {k: torch.from_numpy(v).to(device) for k, v in batch.items()}
        eps = step_noise(m, gt["input_joints"].shape[0], noise_seeds[step], device)
        follow = {"seed_inds": ep_p["seed_inds"].to(device),
                  "fps_inds": ep_p["aggregated_vote_inds"].to(device),
                  "ball_xyz": ep_p["vote_xyz"].to(device)}
        whole = rows_match(ep_p, gt["input_joints"].shape[0])
        ep = ref(gt["input_joints"], eps=eps, follow=follow if whole else None)
        if step == 0:
            with torch.no_grad():
                nums.update(choice_numbers(gt["input_joints"], follow, ep["vote_xyz"].detach(), m) if whole
                            else dict.fromkeys(CHOICE_KEYS, NO_CHOICE))
        loss = detection_loss(ep, gt)["total"]
        loss_gaps.append(abs(loss_p - loss.item()) / abs(loss.item()))
        opt.zero_grad(set_to_none=True)
        loss.backward()
        if grads is None:
            grads = {n: p.grad.detach().clone() for n, p in ref.named_parameters()}
        opt.step()
    nums.update({f"loss{i + 1}_gap": g for i, g in enumerate(loss_gaps)})
    names = [n for n, _ in ref.named_parameters()]
    g1 = leaf_gaps(record["grad1"], grads, names)
    nums["grad_gap"] = max(g1.values())
    gnorm = {n: float(torch.linalg.vector_norm(grads[n])) for n in names}
    med = float(np.median(list(gnorm.values())))
    moved = [n for n in names if gnorm[n] >= 1e-3 * med]
    final = dict(ref.named_parameters())
    delta_p = {n: record["params3"][n].to(device) - weights0[n].to(device) for n in moved}
    delta_r = {n: final[n].detach() - weights0[n].to(device) for n in moved}
    gaps = leaf_gaps(delta_p, delta_r, moved)
    nums["update_gap"] = max(gaps.values())
    nums["update_gap_median"] = float(np.median(list(gaps.values())))
    cos = leaf_cos_gaps(delta_p, delta_r, moved)
    nums["update_cos"] = max(cos.values())
    nums["update_cos_median"] = float(np.median(list(cos.values())))
    # what a reading rests on (not compared): the worst leaves
    nums["worst_update_leaf"] = max(gaps, key=gaps.get)
    nums["worst_grad_leaf"] = max(g1, key=g1.get)
    nums["worst_cos_leaf"] = max(cos, key=cos.get)
    return nums


CHOICE_KEYS = ("seed_gap", "vote_gap", "fps_gap", "ball_gap")


def rows_match(outputs, rows):
    """Whether every output has a row for each of the batch's ``rows``."""
    return all(v.shape[0] == rows for v in outputs.values())


def choice_numbers(joints, follow, ref_votes, m):
    return {
        "seed_gap": seed_gap(joints, follow["seed_inds"], m["num_seeds"]),
        "vote_gap": float((follow["ball_xyz"] - ref_votes).abs().max()),
        "fps_gap": fps_gap(ref_votes, follow["fps_inds"]),
        "ball_gap": ball_gap(ref_votes, follow["ball_xyz"], follow["fps_inds"]),
    }


def adam(model, optim_cfg):
    return torch.optim.Adam(model.parameters(), lr=float(optim_cfg["lr"]), betas=tuple(optim_cfg["betas"]),
                            eps=float(optim_cfg["eps"]), weight_decay=float(optim_cfg["weight_decay"]),
                            foreach=False)


def step_noise(m, batch, seed, device):
    gen = torch.Generator().manual_seed(seed)
    return {k: v.to(device) for k, v in ref_model.mdn_noise(batch, m["num_proposals"], m["num_gaussian"],
                                                             gen).items()}


def reference_record(model_cfg, optim_cfg, weights0, batches, noise_seeds, device, half=False):
    """A train record made by the reference put in the program's place, at
    the precision the caller set (the control), or with ``half`` the batch
    left out and the mean taken over the rest (a planted fault)."""
    ref = build_reference(model_cfg, weights0, device).train()
    opt = adam(ref, optim_cfg)
    beta1 = float(optim_cfg["betas"][0])
    rec = {"batches": batches, "end_points": [], "losses": []}
    for step, batch in enumerate(batches):
        gt = {k: torch.from_numpy(v).to(device) for k, v in batch.items()}
        n = gt["input_joints"].shape[0]
        eps = step_noise(model_cfg, n, noise_seeds[step], device)
        if half:
            gt = {k: v[: n // 2] for k, v in gt.items()}
            eps = {k: v[: n // 2] for k, v in eps.items()}
        ep = ref(gt["input_joints"], eps=eps)
        loss = detection_loss(ep, gt)["total"]
        keep = {k: ep[k].detach().cpu() for k in CHOICE_OUTPUTS}
        if half:  # the outputs of the rows it left out: the kept rows again
            keep = {k: torch.cat([v, v]) for k, v in keep.items()}
        rec["end_points"].append(keep)
        rec["losses"].append(loss.item())
        opt.zero_grad(set_to_none=True)
        loss.backward()
        opt.step()
        if step == 0:
            rec["grad1"] = {nm: opt.state[p]["exp_avg"].cpu() / (1 - beta1) for nm, p in ref.named_parameters()}
    rec["params3"] = {nm: p.detach().cpu().clone() for nm, p in ref.named_parameters()}
    return rec


def judge(numbers, limits):
    """(correct, {name: {"value", "limit"}}) over the numbers the cell's
    limits name: each finite and within its limit; a limit with no number
    fails."""
    checks = {k: {"value": float(numbers.get(k, float("nan"))), "limit": float(v)} for k, v in limits.items()}
    ok = all(np.isfinite(c["value"]) and c["value"] <= c["limit"] for c in checks.values())
    return ok, checks
