"""P2RNet detection loss: vote + objectness + box (center/size/heading) + cls.

Port of pose2room_tpu/models/loss.py (reference models/loss.py:35-189,
BoxNetDetectionLoss), with the same terms, weights and masking:

* vote loss: GT hip votes gathered at the seed frames; per seed the GT vote
  whose target is nearest any of the seed's joints (Chamfer between the 3
  GT votes and the joints); huber on vote_xyz - chosen vote; masked mean;
* objectness: nearest valid GT center per proposal (padded GT columns +1e9)
  -> object_assignment; label 1 within 0.3, supervised also beyond 0.6;
  class-weighted CE [0.1, 0.9];
* box: bidirectional center Chamfer over the FULL padded GT array, huber on
  log-size and (sin, cos) heading of the assigned GT, CE on the class, all
  gated by the objectness label;
* total = 10*vote + 5*objectness + 10*center + 10*size + 10*heading + sem_cls;
* ``eval_nn_loss``: the reference trainer's alternative validation loss.

Data parallel (``reduce``): every normaliser is a sum over the global batch
(the masks' sums, the proposal count), as in the JAX package's sharded
step, so each rank's terms are its numerators over the global normalisers:
its share of the global loss, whose gradient is the sum of the ranks'.
"""

import torch
import torch.nn.functional as F

from pose2room_tpu_torch.ops.nn_distance import huber_loss, nn_distance
from pose2room_tpu_torch.parallel.collectives import data_count

FAR_THRESHOLD = 0.6
NEAR_THRESHOLD = 0.3
GT_VOTE_FACTOR = 3
OBJECTNESS_CLS_WEIGHTS = (0.1, 0.9)
_BIG = 1e9


def _weighted_ce(logits, labels, weights=None):
    """Per-element cross entropy -w_y * log p_y.  bf16 logits give a bf16
    log-softmax, as in the JAX package; the class weights are f32 (so a
    weighted bf16 term comes out f32, as JAX promotes it)."""
    ce = -torch.gather(F.log_softmax(logits, dim=-1), -1, labels[..., None])[..., 0]
    if weights is not None:
        w = torch.tensor(weights, dtype=torch.promote_types(ce.dtype, torch.float32), device=ce.device)
        ce = ce * w[labels]
    return ce


def _take(values, idx):
    """values (B, K, ...) gathered at idx (B, S) along dim 1 -> (B, S, ...)."""
    idx = idx.long().reshape(idx.shape + (1,) * (values.dim() - 2))
    return torch.gather(values, 1, idx.expand(idx.shape[:2] + values.shape[2:]))


def compute_vote_loss(end_points, gt, origin_joint_id=0):
    """(numerator, normaliser) of the vote loss."""
    seed_skeleton = end_points["seed_skeleton"]  # (B,S,V,3)
    B, S, V, _ = seed_skeleton.shape
    seed_inds = end_points["seed_inds"]  # (B,S)
    mask = _take(gt["vote_label_mask"][:, :, origin_joint_id], seed_inds).float()  # (B,S)
    votes = _take(gt["vote_label"][:, :, origin_joint_id, :], seed_inds)  # (B,S,9)
    votes = votes.reshape(B, S, GT_VOTE_FACTOR, 3)
    votes = seed_skeleton[:, :, origin_joint_id : origin_joint_id + 1, :] + votes

    # per seed, the GT vote whose target is nearest any joint
    flat_votes = votes.reshape(B * S, GT_VOTE_FACTOR, 3)
    _, _, dist2, ind2 = nn_distance(flat_votes, seed_skeleton.reshape(B * S, V, 3))
    jstar = torch.argmin(dist2, dim=1)  # (B*S,)
    chosen = torch.gather(ind2, 1, jstar[:, None])  # (B*S, 1)
    gt_vote = _take(flat_votes, chosen)[:, 0].reshape(B, S, 3)

    per_seed = huber_loss(end_points["vote_xyz"] - gt_vote, delta=1.0).mean(-1)
    return (per_seed * mask).sum(), mask.sum()


def compute_correspondence(end_points, gt):
    """(object_assignment, objectness numerator, label, mask); the
    objectness loss is its numerator over ``mask.sum()``."""
    agg_xyz = end_points["aggregated_vote_xyz"]  # (B,K,3)
    gt_center = gt["center_label"][:, :, 0:3]  # (B,K2,3)
    box_mask = gt["box_label_mask"]  # (B,K2)

    diff = agg_xyz[:, :, None, :] - gt_center[:, None, :, :]
    d2 = (diff * diff).sum(-1) + (1.0 - box_mask)[:, None, :] * _BIG
    dist1 = d2.amin(2)
    object_assignment = d2.argmin(2)  # (B,K)

    euclid = torch.sqrt(dist1 + 1e-6)
    objectness_label = (euclid < NEAR_THRESHOLD).long()
    objectness_mask = ((euclid < NEAR_THRESHOLD) | (euclid > FAR_THRESHOLD)).float()
    ce = _weighted_ce(end_points["objectness_scores"], objectness_label, OBJECTNESS_CLS_WEIGHTS)
    return object_assignment, (ce * objectness_mask).sum(), objectness_label, objectness_mask


def compute_box_and_sem_cls_loss(end_points, gt, object_assignment, objectness_label, label_sum, box_sum):
    """(center, size, heading, sem_cls) losses; ``label_sum`` and ``box_sum``:
    the sums of the objectness label and of the GT box mask (global ones in
    a data-parallel step)."""
    label = objectness_label.float()
    denom = label_sum + 1e-6

    # center: bidirectional Chamfer over the full padded GT array
    box_mask = gt["box_label_mask"]
    dist1, _, dist2, _ = nn_distance(end_points["center"], gt["center_label"])
    loss1 = (dist1 * label).sum() / denom
    loss2 = (dist2 * box_mask).sum() / (box_sum + 1e-6)
    center_loss = (loss1 + loss2) / 2.0

    size_l = huber_loss(end_points["size"] - _take(gt["size"], object_assignment), delta=1.0).mean(-1)
    size_loss = (size_l * label).sum() / denom

    heading_l = huber_loss(
        end_points["heading"] - _take(gt["heading"], object_assignment), delta=1.0
    ).mean(-1)
    heading_loss = (heading_l * label).sum() / denom

    gt_cls = torch.gather(gt["sem_cls_label"].long(), 1, object_assignment)
    sem_cls_loss = (_weighted_ce(end_points["sem_cls_scores"], gt_cls) * label).sum() / denom
    return center_loss, size_loss, heading_loss, sem_cls_loss


def detection_loss(end_points, gt, origin_joint_id=0, reduce=None):
    """Full BoxNetDetectionLoss: a dict of scalar tensors ('total' drives the
    gradient; the rest are logging statistics).

    ``reduce``: None for the batch at hand, or a function that sums a tensor
    over the ranks of a data-parallel step (``parallel.all_reduce_sum_``,
    over the data group under a tensor-parallel grid):
    the normalisers then go through it in one call, and the proposal count
    is every rank's (each holds the same number), so each term is this
    rank's share of the global one and the global loss is their sum."""
    vote_num, vote_den = compute_vote_loss(end_points, gt, origin_joint_id)
    object_assignment, objectness_num, objectness_label, objectness_mask = (
        compute_correspondence(end_points, gt)
    )
    n_prop = objectness_label.numel()
    sums = (vote_den, objectness_mask.sum(), objectness_label.float().sum(), gt["box_label_mask"].sum())
    if reduce is not None:
        # one collective; the sums are counts, exact in every dtype they take
        sums = [r.to(t.dtype) for r, t in zip(reduce(torch.stack(sums)).unbind(0), sums)]
        n_prop *= data_count()
    vote_den, mask_sum, label_sum, box_sum = sums
    vote_loss = vote_num / (vote_den + 1e-6)
    objectness_loss = objectness_num / (mask_sum + 1e-6)
    center_loss, size_loss, heading_loss, sem_cls_loss = compute_box_and_sem_cls_loss(
        end_points, gt, object_assignment, objectness_label, label_sum, box_sum
    )
    total = (
        10.0 * vote_loss
        + 5.0 * objectness_loss
        + 10.0 * center_loss
        + 10.0 * size_loss
        + 10.0 * heading_loss
        + sem_cls_loss
    )
    pos_ratio = objectness_label.float().sum() / n_prop
    neg_ratio = objectness_mask.sum() / n_prop - pos_ratio
    obj_pred = end_points["objectness_scores"].argmax(2)
    obj_acc = ((obj_pred == objectness_label).float() * objectness_mask).sum() / (mask_sum + 1e-6)
    return {
        "total": total,
        "vote_loss": vote_loss,
        "objectness_loss": objectness_loss,
        "center_loss": center_loss,
        "size_loss": size_loss,
        "heading_loss": heading_loss,
        "sem_cls_loss": sem_cls_loss,
        "pos_ratio": pos_ratio,
        "neg_ratio": neg_ratio,
        "obj_acc": obj_acc,
    }


def eval_nn_assignment(end_points, gt_data):
    """``eval_nn_loss``'s pairwise smooth-L1 center distance (B, K, K2)
    (nn_distance l1smooth=True), +_BIG on the padded GT columns, and each
    proposal's nearest GT box (B, K)."""
    diff = end_points["center"][:, :, None, :] - gt_data["center_label"][:, None, :, 0:3]
    pc_dist = huber_loss(diff, delta=1.0).sum(-1) + (1.0 - gt_data["box_label_mask"])[:, None, :] * _BIG
    return pc_dist, pc_dist.argmin(2)


def eval_nn_loss(end_points, gt_data):
    """Alternative validation loss, reference Trainer.eval_nn_loss
    (models/p2rnet/training.py:38-91; defined but unused in the reference
    loop): smooth-L1 Chamfer on centers over the VALID GT boxes, then size,
    heading and class penalties gathered at each proposal's nearest GT box,
    with no objectness gating.

    The padded (B, K2) GT array is masked with +_BIG on the padded columns,
    a suffix, so the first minimum ``torch.argmin`` returns is the index the
    reference's slice of the valid prefix gives.  total = 10*center +
    10*size + 10*heading + sem_cls (training.py:83).
    """
    box_mask = gt_data["box_label_mask"]  # (B,K2)
    B, K = end_points["center"].shape[:2]
    pc_dist, object_assignment = eval_nn_assignment(end_points, gt_data)
    dist1 = pc_dist.amin(2)
    dist2 = pc_dist.amin(1)  # (B,K2); the padded columns are masked in the sum

    centroid_reg_loss1 = dist1.sum() / (B * K + 1e-6)
    centroid_reg_loss2 = (dist2 * box_mask).sum() / (box_mask.sum() + 1e-6)
    center_loss = (centroid_reg_loss1 + centroid_reg_loss2) / 2.0

    size_loss = huber_loss(end_points["size"] - _take(gt_data["size"], object_assignment), delta=1.0).mean(-1).mean()
    heading_loss = huber_loss(
        end_points["heading"] - _take(gt_data["heading"], object_assignment), delta=1.0
    ).mean(-1).mean()
    gt_cls = torch.gather(gt_data["sem_cls_label"].long(), 1, object_assignment)
    sem_cls_loss = _weighted_ce(end_points["sem_cls_scores"], gt_cls).mean()

    total = 10.0 * center_loss + 10.0 * size_loss + 10.0 * heading_loss + sem_cls_loss
    return {
        "total": total,
        "center_loss": center_loss,
        "size_loss": size_loss,
        "heading_loss": heading_loss,
        "sem_cls_loss": sem_cls_loss,
        "centroid_reg_loss1": centroid_reg_loss1,
        "centroid_reg_loss2": centroid_reg_loss2,
    }
