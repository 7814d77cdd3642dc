"""P2RNet's detection loss (BoxNetDetectionLoss, reference models/loss.py),
plain PyTorch on one process: vote, objectness, centre, size, heading and
class terms with the published weights."""

import torch
import torch.nn.functional as F

NEAR, FAR = 0.3, 0.6
OBJ_WEIGHTS = (0.1, 0.9)
BIG = 1e9


def huber(x, delta=1.0):
    a = x.abs()
    q = a.clamp(max=delta)
    return 0.5 * q ** 2 + delta * (a - q)


def nearest(a, b):
    """Squared distances a (B, N, 3) x b (B, M, 3) -> (min over b, argmin
    over b, min over a, argmin over a)."""
    d = ((a[:, :, None] - b[:, None]) ** 2).sum(-1)
    return d.amin(2), d.argmin(2), d.amin(1), d.argmin(1)


def take(x, idx):
    return x[torch.arange(x.shape[0], device=x.device)[:, None], idx.long()]


def ce(logits, labels, weights=None):
    out = -F.log_softmax(logits, -1).gather(-1, labels[..., None])[..., 0]
    if weights is not None:
        out = out * torch.tensor(weights, device=out.device)[labels]
    return out


def detection_loss(ep, gt):
    """Scalar loss terms of one batch; 'total' is the trained one."""
    seeds = ep["seed_inds"]
    skel = ep["seed_skeleton"]  # (B, S, V, 3)
    B, S, V, _ = skel.shape
    mask = take(gt["vote_label_mask"][:, :, 0], seeds).float()
    votes = take(gt["vote_label"][:, :, 0], seeds).reshape(B, S, 3, 3) + skel[:, :, :1]
    # per seed the GT vote whose target is nearest any of its joints
    d = ((votes.reshape(B * S, 3, 1, 3) - skel.reshape(B * S, 1, V, 3)) ** 2).sum(-1)
    best = d.amin(1).argmin(1)  # the joint nearest any vote
    chosen = d.argmin(1).gather(1, best[:, None])[:, 0]  # that joint's nearest vote
    gt_vote = votes.reshape(B * S, 3, 3)[torch.arange(B * S, device=d.device), chosen].reshape(B, S, 3)
    vote_loss = (huber(ep["vote_xyz"] - gt_vote).mean(-1) * mask).sum() / (mask.sum() + 1e-6)

    box_mask = gt["box_label_mask"]
    dd = ((ep["aggregated_vote_xyz"][:, :, None] - gt["center_label"][:, None]) ** 2).sum(-1)
    dd = dd + (1.0 - box_mask)[:, None] * BIG
    assign = dd.argmin(2)
    dist = torch.sqrt(dd.amin(2) + 1e-6)
    label = (dist < NEAR).long()
    obj_mask = ((dist < NEAR) | (dist > FAR)).float()
    objectness_loss = (ce(ep["objectness_scores"], label, OBJ_WEIGHTS) * obj_mask).sum() / (obj_mask.sum() + 1e-6)

    lab = label.float()
    denom = lab.sum() + 1e-6
    d1, _, d2, _ = nearest(ep["center"], gt["center_label"])
    center_loss = ((d1 * lab).sum() / denom + (d2 * box_mask).sum() / (box_mask.sum() + 1e-6)) / 2.0
    size_loss = (huber(ep["size"] - take(gt["size"], assign)).mean(-1) * lab).sum() / denom
    heading_loss = (huber(ep["heading"] - take(gt["heading"], assign)).mean(-1) * lab).sum() / denom
    sem_cls_loss = (ce(ep["sem_cls_scores"], gt["sem_cls_label"].long().gather(1, assign)) * lab).sum() / denom
    total = (10.0 * vote_loss + 5.0 * objectness_loss + 10.0 * center_loss + 10.0 * size_loss
             + 10.0 * heading_loss + sem_cls_loss)
    return {"total": total, "vote_loss": vote_loss, "objectness_loss": objectness_loss,
            "center_loss": center_loss, "size_loss": size_loss, "heading_loss": heading_loss,
            "sem_cls_loss": sem_cls_loss}
