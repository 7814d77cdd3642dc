"""Mixture-density (GMM) heads with sigmoid mixture weights.

Port of pose2room_tpu/models/mdn.py (reference
models/p2rnet/modules/mdn.py:17-161): a learnable global ``mu`` (G, D) set
from task-specific grids, ``pi = sigmoid(linear(h))`` (sigmoid, not softmax),
the deterministic ``get_mean`` = sum_g pi_g * mu_g, and the train path's
``predict``: the pi-weighted sum over gaussians of mu + eps * sigma,
averaged over the samples.  The noise eps is an argument, never drawn here,
so the card, the CPU and the JAX package's rng streams can be fed the same
numbers.  Multi-mode generation (Bernoulli pi) is not ported yet.
"""

import numpy as np
import torch
from torch import nn

from pose2room_tpu_torch.models.layers import SingleConv


class _MDN(nn.Module):
    """Reference key ``mdn``: ``pi.conv``, ``mu``, ``log_sigma``."""

    def __init__(self, hidden_dim, num_gaussian, out_dim):
        super().__init__()
        self.pi = SingleConv(hidden_dim, num_gaussian, bias=True, bn=False, relu=False)
        self.mu = nn.Parameter(torch.zeros(num_gaussian, out_dim))
        self.log_sigma = nn.Parameter(torch.zeros(num_gaussian, out_dim))


class MDNHead(nn.Module):
    def __init__(self, num_gaussian, out_dim, mu_init, hidden_dim=128, bn_momentum=0.9):
        super().__init__()
        mu_init = np.asarray(mu_init, dtype=np.float32)
        if mu_init.shape != (num_gaussian, out_dim):
            raise ValueError(f"mu_init shape {mu_init.shape} != {(num_gaussian, out_dim)}")
        self._mu_init = mu_init
        self.out_dim = out_dim
        self.backbone = SingleConv(hidden_dim, hidden_dim, bias=False, bn=True, relu=True,
                                   bn_momentum=bn_momentum)
        self.mdn = _MDN(hidden_dim, num_gaussian, out_dim)

    def reset_parameters(self, generator):
        self.backbone.reset_parameters(generator)
        self.mdn.pi.reset_parameters(generator)
        with torch.no_grad():
            self.mdn.mu.copy_(torch.from_numpy(self._mu_init))
            self.mdn.log_sigma.zero_()

    def pi(self, x):
        """x: (B, P, C) -> mixture weights (B, P, G)."""
        return torch.sigmoid(self.mdn.pi(self.backbone(x)))

    def get_mean(self, x):
        """Deterministic eval: (pi-weighted mu (B, P, D), pi (B, P, G))."""
        pi = self.pi(x)
        return torch.einsum("bpg,gd->bpd", pi, self.mdn.mu), pi

    def _samples(self, pi, eps):
        """pi (B, P, G), eps (B, P, G, n, D) -> (B, P, n, D):
        sum_g pi_g * (mu_g + eps * sigma_g)."""
        sigma = torch.exp(self.mdn.log_sigma)  # (G, D)
        draws = self.mdn.mu[None, None, :, None, :] + eps * sigma[None, None, :, None, :]
        return (draws * pi[:, :, :, None, None]).sum(2)

    def predict(self, x, eps):
        """Train-path prediction (B, P, D): the mean over eps's n samples of
        the pi-weighted gaussian draws.  eps: (B, P, G, n, D) standard normal."""
        return self._samples(self.pi(x), eps).mean(2)


def center_mu_init(num_gaussian):
    """Sphere-shell grid of radius 0.1 (reference proposal_net.py:98-111)."""
    n_bins_theta = int(np.ceil(np.sqrt(num_gaussian / 2)))
    n_bins_phi = 2 * n_bins_theta
    bin_width = np.pi / n_bins_theta
    phi = np.array([bin_width * i - np.pi for i in range(n_bins_phi)])
    theta = np.linspace(0, np.pi, n_bins_theta + 2)[1:-1]
    grids = np.array(np.meshgrid(phi, theta)).reshape(2, -1).T  # (n,2): (phi, theta)
    pts = np.stack(
        [
            0.1 * np.sin(grids[:, 1]) * np.cos(grids[:, 0]),
            0.1 * np.sin(grids[:, 1]) * np.sin(grids[:, 0]),
            0.1 * np.cos(grids[:, 1]),
        ],
        axis=1,
    )
    if num_gaussian < len(pts):
        pts = _fps_downselect(pts, num_gaussian)
    return pts.astype(np.float32)


def size_mu_init(num_gaussian):
    """Log-space grid over [0.05, 3]^3 (reference proposal_net.py:112-117)."""
    bins = int(np.ceil(num_gaussian ** (1 / 3)))
    g = np.linspace(0.05, 3, bins)
    grid = np.log(np.array(np.meshgrid(g, g, g)).reshape(3, -1).T)
    return _fps_downselect(grid, num_gaussian).astype(np.float32)


def heading_mu_init(num_gaussian):
    """Unit circle (sin, cos) bins (reference proposal_net.py:118-122)."""
    bin_width = 2 * np.pi / num_gaussian
    thetas = np.array([bin_width * i - np.pi for i in range(num_gaussian)])
    return np.stack([np.sin(thetas), np.cos(thetas)], axis=1).astype(np.float32)


def _fps_downselect(points, npoint):
    """Deterministic farthest-point downselect of an init grid (host numpy),
    starting from point 0; indices sorted ascending (proposal_net.py:130)."""
    n = len(points)
    if npoint >= n:
        return points
    dist = np.full(n, np.inf)
    picked = [0]
    for _ in range(npoint - 1):
        d = np.sum((points - points[picked[-1]]) ** 2, axis=1)
        dist = np.minimum(dist, d)
        masked = dist.copy()
        masked[picked] = -np.inf
        picked.append(int(np.argmax(masked)))
    return points[np.sort(picked)]
