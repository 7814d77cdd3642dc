"""The weights of a run, made from the seed on the device.

One standard-normal draw of every entry of every leaf, in one call on a
generator of the run's device, then each leaf shaped by its role: layer
kernels at 1/sqrt(fan_in) (lecun), biases and BatchNorm shifts small, BN
scales, edge importances and running variances near 1, running means
near 0, the mixture means at the published grids plus a small jitter.
Every leaf is random so that a fold, a layout or a parameter that the
program drops shows in the comparison.  The names are the published
state_dict's, which both the program and the reference load.
"""

import math

import torch

BN_PARTS = ("batchnorm.", "tcn.0.", "tcn.3.")


def role(name):
    if name.endswith("running_mean"):
        return "running_mean"
    if name.endswith("running_var"):
        return "running_var"
    if "edge_importance" in name:
        return "importance"
    if name.endswith("mdn.mu"):
        return "mu"
    if name.endswith("mdn.log_sigma"):
        return "log_sigma"
    if any(p in name for p in BN_PARTS):
        return "bn_" + name.rsplit(".", 1)[1]
    return "kernel" if name.endswith(".weight") else "bias"


def make_weights(shapes, mu_init, seed, device):
    """{name: float32 tensor on ``device``} for {name: shape}; ``mu_init``:
    {head: (G, D) array} the mixture-mean grids, by 'gmm_<head>' in the
    name."""
    gen = torch.Generator(device=device).manual_seed(seed)
    total = sum(math.prod(s) for s in shapes.values())
    z = torch.randn(total, generator=gen, device=device)
    out, at = {}, 0
    for name, shape in shapes.items():
        n = math.prod(shape)
        x = z[at:at + n].reshape(shape)
        at += n
        r = role(name)
        if r == "kernel":
            x = x / math.sqrt(n / shape[0])
        elif r in ("bias", "bn_bias", "running_mean"):
            x = 0.05 * x
        elif r in ("bn_weight", "importance"):
            x = 1.0 + 0.1 * x
        elif r == "running_var":
            x = torch.exp(0.2 * x)
        elif r == "log_sigma":
            x = 0.1 * x
        elif r == "mu":
            head = name.split("gmm_")[1].split(".")[0]
            x = torch.as_tensor(mu_init[head], dtype=torch.float32, device=device) + 0.01 * x
        out[name] = x.contiguous()
    return out
