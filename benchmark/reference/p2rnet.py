"""Plain PyTorch P2RNet: the benchmark's reference.

The layer equations of the published model (Pose2Room, ECCV 2022;
reference models/p2rnet/modules), written straight from them in float32
with no kernel, fold, fused layout or batching trick: the ST-GCN graph
convolution is the 1x1 convolution to K partitions followed by the
contraction with the edge-weighted adjacency (not a folded matrix), the
temporal convolution three shifted products, BatchNorm the two-pass
batch moments.  Parameter names are the published state_dict's, so one
weight dict loads into this model and into the program.

Imports neither JAX nor anything of the program.  The caller sets the
precision: ``set_precision(tf32=False)`` before the reference runs (f32
products), ``tf32=True`` for the lower-precision control.

``forward`` takes optional ``follow`` choices (the seed frames, the FPS
picks and the coordinates that decide ball membership): the comparison
validates the program's discrete choices against this model's own values
by a tie-aware gap and then follows them, so that a choice that rounding
alone can flip does not make two sound runs disagree downstream.
"""

import numpy as np
import torch
from torch import nn

from benchmark.reference.graph import spatial_graph

BN_EPS = 1e-5
NEAR_ORIGIN_SQ = 1e-3  # FPS never picks a point this close to the origin
RADIUS, NSAMPLE = 0.3, 16
MDN_DIMS = {"center": 3, "size": 3, "heading": 2}


def set_precision(tf32):
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32


class BN(nn.Module):
    """BatchNorm over the last axis: batch moments in training (biased
    variance), running statistics in eval; running stats follow
    ``ra = m * ra + (1 - m) * batch`` with keep-rate m."""

    def __init__(self, n, momentum=0.9):
        super().__init__()
        self.momentum = momentum
        self.weight = nn.Parameter(torch.ones(n))
        self.bias = nn.Parameter(torch.zeros(n))
        self.register_buffer("running_mean", torch.zeros(n))
        self.register_buffer("running_var", torch.ones(n))

    def forward(self, x):
        if self.training:
            axes = tuple(range(x.dim() - 1))
            mean = x.mean(axes)
            var = ((x - mean) ** 2).mean(axes)
            with torch.no_grad():
                m = self.momentum
                self.running_mean.mul_(m).add_((1 - m) * mean)
                self.running_var.mul_(m).add_((1 - m) * var)
        else:
            mean, var = self.running_mean, self.running_var
        return (x - mean) / torch.sqrt(var + BN_EPS) * self.weight + self.bias


class Conv(nn.Module):
    """1x1 convolution [+ BN] [+ ReLU] (key ``conv`` / ``batchnorm``)."""

    def __init__(self, i, o, bias, bn, relu):
        super().__init__()
        self.conv = nn.Linear(i, o, bias=bias)
        self.batchnorm = BN(o) if bn else None
        self.relu = relu

    def forward(self, x):
        x = self.conv(x)
        if self.batchnorm is not None:
            x = self.batchnorm(x)
        return torch.relu(x) if self.relu else x


def mlp(i, features, final_plain=True):
    """'cbr' stack; a final plain layer has a bias and no BN or ReLU."""
    layers = []
    for n, f in enumerate(features):
        plain = final_plain and n == len(features) - 1
        layers.append(Conv(i, f, bias=plain, bn=not plain, relu=not plain))
        i = f
    return nn.Sequential(*layers)


class TemporalConv(nn.Module):
    """(3, 1) convolution over frames, zero padded, weight (out, in, 3, 1)."""

    def __init__(self, c):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(c, c, 3, 1))
        self.bias = nn.Parameter(torch.zeros(c))

    def forward(self, x):  # (B, T, V, C)
        w = self.weight[..., 0]
        pad = torch.zeros_like(x[:, :1])
        prev = torch.cat([pad, x[:, :-1]], 1)
        nxt = torch.cat([x[:, 1:], pad], 1)
        return prev @ w[:, :, 0].t() + x @ w[:, :, 1].t() + nxt @ w[:, :, 2].t() + self.bias


class GraphConv(nn.Module):
    def __init__(self, c, K):
        super().__init__()
        self.conv = nn.Linear(c, c * K)


class Block(nn.Module):
    """ST-GCN block: graph conv, BN, ReLU, temporal conv, BN, residual, ReLU."""

    def __init__(self, c, K, residual):
        super().__init__()
        self.K, self.residual = K, residual
        self.gcn = GraphConv(c, K)
        self.tcn = nn.Sequential(BN(c), nn.ReLU(), TemporalConv(c), BN(c))

    def forward(self, x, A):  # x (B, T, V, C), A (K, V, V)
        B, T, V, C = x.shape
        xw = self.gcn.conv(x).reshape(B, T, V, self.K, C)
        y = torch.einsum("btvkc,kvw->btwc", xw, A)
        y = self.tcn(y)
        return torch.relu(y + x) if self.residual else torch.relu(y)


def seed_frames(origin, n_seeds):
    """Arc-length resampling of the hip path in float64: per target the
    frame whose cumulative distance is nearest.  Returns (indices (B, S),
    cost (B, T, S): |cum - target| in metres)."""
    o = origin.double()
    step = torch.linalg.vector_norm(o[:, 1:] - o[:, :-1], dim=-1)
    cum = torch.cat([step.new_zeros(o.shape[0], 1), torch.cumsum(step, 1)], 1)
    target = cum[:, -1:] / (n_seeds - 1) * torch.arange(n_seeds, dtype=o.dtype, device=o.device)
    cost = (cum[:, :, None] - target[:, None, :]).abs()
    return cost.argmin(1), cost


def fps(xyz, npoint):
    """Furthest point sampling, first pick index 0, ties to the lowest
    index, points within sqrt(1e-3) of the origin never picked."""
    B, N, _ = xyz.shape
    valid = (xyz * xyz).sum(-1) > NEAR_ORIGIN_SQ
    mind = torch.full((B, N), 1e10, dtype=xyz.dtype, device=xyz.device)
    rows = torch.arange(B, device=xyz.device)
    last = torch.zeros(B, dtype=torch.long, device=xyz.device)
    picks = [last]
    for _ in range(npoint - 1):
        d = ((xyz - xyz[rows, last][:, None]) ** 2).sum(-1)
        mind = torch.where(valid, torch.minimum(mind, d), mind)
        last = torch.where(valid, mind, torch.full_like(mind, -1.0)).argmax(1)
        picks.append(last)
    return torch.stack(picks, 1)


def ball_hits(centers, xyz):
    """d^2 < r^2 of every (center, point) pair, with d^2 written as
    |c|^2 + |p|^2 - 2 c.p term by term in float32 (pointnet2's order)."""
    c, p = centers[:, :, None, :], xyz[:, None, :, :]
    dot = c[..., 0] * p[..., 0] + c[..., 1] * p[..., 1] + c[..., 2] * p[..., 2]
    sq = lambda t: t[..., 0] * t[..., 0] + t[..., 1] * t[..., 1] + t[..., 2] * t[..., 2]  # noqa: E731
    d2 = sq(centers)[:, :, None] + sq(xyz)[:, None, :] - 2.0 * dot
    return d2 < RADIUS * RADIUS


def ball_slots(hits):
    """The first NSAMPLE hits of each ball in scan order; short balls repeat
    the first hit, empty balls give index 0."""
    N = hits.shape[-1]
    order = torch.arange(N, device=hits.device)
    key = torch.where(hits, order, torch.full_like(order, N))
    slots = key.sort(-1).values[..., :NSAMPLE]
    slots = torch.where(slots == N, slots[..., :1], slots)
    return torch.where(slots == N, torch.zeros_like(slots), slots)


def take(x, idx):
    """x (B, N, ...) at idx (B, M) -> (B, M, ...)."""
    return x[torch.arange(x.shape[0], device=x.device)[:, None], idx.long()]


def center_mu(G):
    nt = int(np.ceil(np.sqrt(G / 2)))
    phi = np.array([np.pi / nt * i - np.pi for i in range(2 * nt)])
    theta = np.linspace(0, np.pi, nt + 2)[1:-1]
    g = np.array(np.meshgrid(phi, theta)).reshape(2, -1).T
    pts = 0.1 * np.stack([np.sin(g[:, 1]) * np.cos(g[:, 0]), np.sin(g[:, 1]) * np.sin(g[:, 0]),
                          np.cos(g[:, 1])], 1)
    return _downselect(pts, G)


def size_mu(G):
    b = int(np.ceil(G ** (1 / 3)))
    g = np.linspace(0.05, 3, b)
    return _downselect(np.log(np.array(np.meshgrid(g, g, g)).reshape(3, -1).T), G)


def heading_mu(G):
    th = np.array([2 * np.pi / G * i - np.pi for i in range(G)])
    return np.stack([np.sin(th), np.cos(th)], 1)


def _downselect(points, n):
    """Farthest-point subset of an init grid from point 0, sorted."""
    if n >= len(points):
        return points
    dist, picked = np.full(len(points), np.inf), [0]
    for _ in range(n - 1):
        dist = np.minimum(dist, ((points - points[picked[-1]]) ** 2).sum(1))
        masked = dist.copy()
        masked[picked] = -np.inf
        picked.append(int(masked.argmax()))
    return points[np.sort(picked)]


MU_INIT = {"center": center_mu, "size": size_mu, "heading": heading_mu}


class MDN(nn.Module):
    def __init__(self, hidden, G, D):
        super().__init__()
        self.pi = Conv(hidden, G, bias=True, bn=False, relu=False)
        self.mu = nn.Parameter(torch.zeros(G, D))
        self.log_sigma = nn.Parameter(torch.zeros(G, D))


class MDNHead(nn.Module):
    """Sigmoid-weighted gaussian mixture: the mean sum_g pi_g mu_g, or the
    train path's pi-weighted draws mu + eps * sigma, summed over G and
    averaged over the samples."""

    def __init__(self, G, D, hidden=128):
        super().__init__()
        self.backbone = Conv(hidden, hidden, bias=False, bn=True, relu=True)
        self.mdn = MDN(hidden, G, D)

    def forward(self, x, eps=None):
        pi = torch.sigmoid(self.mdn.pi(self.backbone(x)))  # (B, P, G)
        if eps is None:
            return pi @ self.mdn.mu
        draws = self.mdn.mu[:, None] + eps * torch.exp(self.mdn.log_sigma)[:, None]  # (B,P,G,n,D)
        return (draws * pi[..., None, None]).sum(2).mean(2)


class VoteAggregation(nn.Module):
    def __init__(self, c):
        super().__init__()
        self.mlp_module = nn.Sequential(nn.Linear(c, 256), nn.ReLU(), nn.Linear(256, c), nn.ReLU())


class Backbone(nn.Module):
    def __init__(self, V, C, K, knn=20, out=256):
        super().__init__()
        self.knn = knn
        self.pos_embed = mlp(3, [64, 64, C])
        self.sk_feat = mlp(3, [64, 64, C])
        self.st_gcn_networks = nn.ModuleList(Block(C, K, residual=i > 0) for i in range(6))
        self.edge_importance = nn.ParameterList(nn.Parameter(torch.ones(K, V, V)) for _ in range(6))
        self.conv_joint = nn.Linear(V * C, out)


class CenterVoting(nn.Module):
    def __init__(self, c=256):
        super().__init__()
        self.conv_input = mlp(c, [256, 256, 3 + c])


class Detection(nn.Module):
    def __init__(self, num_class, G, c=256, gmm=128):
        super().__init__()
        self.vote_aggregation = VoteAggregation(c)
        self.conv_center = mlp(c, [128, gmm], final_plain=False)
        self.conv_size = mlp(c, [128, gmm], final_plain=False)
        self.conv_heading = mlp(c, [128, gmm], final_plain=False)
        self.conv_sem_obj = mlp(c, [128, 128, 2 + num_class])
        self.gmm_center = MDNHead(G, 3)
        self.gmm_size = MDNHead(G, 3)
        self.gmm_heading = MDNHead(G, 2)


class P2RNet(nn.Module):
    def __init__(self, *, num_frames=768, num_seeds=512, num_proposals=128, num_gaussian=100,
                 num_class=22, num_joints=53, channels=64, max_hop=5):
        super().__init__()
        self.T, self.S, self.P, self.G = num_frames, num_seeds, num_proposals, num_gaussian
        A = torch.from_numpy(spatial_graph(num_joints, max_hop))
        self.register_buffer("A", A, persistent=False)
        self.backbone = Backbone(num_joints, channels, A.shape[0])
        self.centervoting = CenterVoting()
        self.detection = Detection(num_class, num_gaussian)

    def mdn_mu_init(self):
        """{head: (G, D) float64} the published mixture-mean grids."""
        return {k: MU_INIT[k](self.G) for k in MDN_DIMS}

    def forward(self, joints, eps=None, follow=None):
        """joints (B, T, V, 3) -> end points.  ``eps``: the MDN noise
        {head: (B, P, G, n, D)} of the train path (None: the mixture means).
        ``follow``: {"seed_inds", "fps_inds", "ball_xyz"} choices to use in
        place of this model's own (any subset)."""
        follow = follow or {}
        bb = self.backbone
        B, T, V, _ = joints.shape
        origin = joints[:, :, 0]
        own_seeds, _ = seed_frames(origin, self.S)
        seed_inds = follow.get("seed_inds", own_seeds).long()

        win = torch.arange(T, device=joints.device)[:, None] + torch.arange(-(bb.knn // 2), bb.knn // 2,
                                                                          device=joints.device)
        neigh = origin[:, win.clamp(0, T - 1)]  # (B, T, knn, 3)
        pos = bb.pos_embed(neigh - origin[:, :, None]).mean(2)
        h = bb.sk_feat(joints - joints[:, :, :1]) + pos[:, :, None]
        for blk, imp in zip(bb.st_gcn_networks, bb.edge_importance):
            h = blk(h, self.A * imp)
        C = h.shape[-1]
        frame_feat = bb.conv_joint(h.permute(0, 1, 3, 2).reshape(B, T, C * V))  # channel-major
        seed_feat = take(frame_feat, seed_inds)
        seed_xyz = take(origin, seed_inds)

        out = self.centervoting.conv_input(seed_feat)
        vote_xyz = seed_xyz + out[..., :3]
        feat = seed_feat + out[..., 3:]
        feat = feat / torch.linalg.vector_norm(feat, dim=-1, keepdim=True).clamp(min=1e-12)

        det = self.detection
        fps_inds = follow.get("fps_inds")
        if fps_inds is None:
            fps_inds = fps(vote_xyz.detach(), self.P).sort(1).values
        fps_inds = fps_inds.long()
        ball_xyz = follow.get("ball_xyz", vote_xyz.detach())
        slots = ball_slots(ball_hits(take(ball_xyz, fps_inds), ball_xyz))  # (B, P, NSAMPLE)
        agg_xyz = take(vote_xyz, fps_inds)
        grouped = take(feat, slots.reshape(B, -1)).reshape(B, self.P, NSAMPLE, -1)
        agg = det.vote_aggregation.mlp_module(grouped).amax(2)
        sem_obj = det.conv_sem_obj(agg)
        preds = {}
        for k in MDN_DIMS:
            f = getattr(det, f"conv_{k}")(agg)
            preds[k] = getattr(det, f"gmm_{k}")(f, None if eps is None else eps[k])
        return {
            "seed_inds": seed_inds, "seed_skeleton": take(joints, seed_inds),
            "vote_xyz": vote_xyz, "aggregated_vote_xyz": agg_xyz, "aggregated_vote_inds": fps_inds,
            "ball_slots": slots,
            "center": agg_xyz + preds["center"], "size": preds["size"], "heading": preds["heading"],
            "objectness_scores": sem_obj[..., :2], "sem_cls_scores": sem_obj[..., 2:],
        }


def mdn_noise(batch, P, G, generator):
    """The train path's MDN noise, one draw per head in the order centre,
    size, heading: {head: (B, P, G, 1, D)} standard normal on the host."""
    return {k: torch.randn((batch, P, G, 1, d), generator=generator) for k, d in MDN_DIMS.items()}
