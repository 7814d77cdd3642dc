"""Weight bridge: flax pytree / reference checkpoint -> the port's state_dict.

The port's ``state_dict()`` uses the reference P2RNet key layout
(models/p2rnet/modules/*), the one pose2room_tpu's
``export_to_reference_state_dict`` writes.  This module is the port's own
copy of that mapping (the port does not import the JAX package):

* Dense kernel (in, out)          -> 1x1 conv weight (out, in);
* flax temporal Conv (3,1,in,out) -> (out, in, 3, 1);
* ``conv_joint``: flax rows are joint-major (v*C + c), the reference
  columns channel-major (c*V + v); the fold re-permutes once per weight load;
* BatchNorm scale/bias/mean/var   -> weight/bias/running_mean/running_var.
"""

import numpy as np
import torch

_BUFFERS = ("num_batches_tracked",)


def _dense(sd, key, sub):
    sd[f"{key}.weight"] = np.asarray(sub["kernel"]).T
    if "bias" in sub:
        sd[f"{key}.bias"] = np.asarray(sub["bias"])


def _bn(sd, key, params, stats):
    sd[f"{key}.weight"] = np.asarray(params["scale"])
    sd[f"{key}.bias"] = np.asarray(params["bias"])
    sd[f"{key}.running_mean"] = np.asarray(stats["mean"])
    sd[f"{key}.running_var"] = np.asarray(stats["var"])


def _mlp(sd, prefix, params, stats):
    n = len([k for k in params if k.startswith("dense")])
    for i in range(n):
        _dense(sd, f"{prefix}.{i}.conv", params[f"dense{i}"])
        if f"bn{i}" in params:
            _bn(sd, f"{prefix}.{i}.batchnorm", params[f"bn{i}"], stats[f"bn{i}"])


def state_dict_from_flax(payload, num_joints=53, joint_channels=64):
    """flax {'params', 'batch_stats'} (numpy leaves) -> the port's state_dict
    (float32 torch tensors), loadable with ``load_state_dict(strict=True)``."""
    params, stats = payload["params"], payload["batch_stats"]
    sd = {}

    bp, bs = params["backbone"], stats["backbone"]
    for name in ("pos_embed", "sk_feat"):
        _mlp(sd, f"backbone.{name}", bp[name], bs[name])
    n_blocks = len([k for k in bp if k.startswith("gcn") and k[3:].isdigit()])
    for i in range(n_blocks):
        pre = f"backbone.st_gcn_networks.{i}"
        blk, bst = bp[f"gcn{i}"], bs[f"gcn{i}"]
        _dense(sd, f"{pre}.gcn.conv", blk["gcn_dense"])
        _bn(sd, f"{pre}.tcn.0", blk["tcn_bn1"], bst["tcn_bn1"])
        sd[f"{pre}.tcn.2.weight"] = np.transpose(np.asarray(blk["tcn_conv"]["kernel"]), (3, 2, 0, 1))
        sd[f"{pre}.tcn.2.bias"] = np.asarray(blk["tcn_conv"]["bias"])
        _bn(sd, f"{pre}.tcn.3", blk["tcn_bn2"], bst["tcn_bn2"])
    for i in range(n_blocks):
        sd[f"backbone.edge_importance.{i}"] = np.asarray(bp[f"edge_importance{i}"])
    C, V = joint_channels, num_joints
    perm = np.array([c * V + v for v in range(V) for c in range(C)])
    kj = np.asarray(bp["conv_joint"]["kernel"]).T  # (256, V*C) joint-major
    w = np.empty_like(kj)
    w[:, perm] = kj
    sd["backbone.conv_joint.weight"] = w
    sd["backbone.conv_joint.bias"] = np.asarray(bp["conv_joint"]["bias"])

    _mlp(sd, "centervoting.conv_input", params["centervoting"]["conv_input"],
         stats["centervoting"]["conv_input"])

    dp, ds = params["detection"], stats["detection"]
    for i, ti in enumerate((0, 2)):
        _dense(sd, f"detection.vote_aggregation.mlp_module.{ti}", dp["sa_mlp"][f"dense{i}"])
    for name in ("conv_center", "conv_size", "conv_heading", "conv_sem_obj"):
        _mlp(sd, f"detection.{name}", dp[name], ds[name])
    for g in ("gmm_center", "gmm_size", "gmm_heading"):
        pre = f"detection.{g}"
        _dense(sd, f"{pre}.backbone.conv", dp[g]["backbone"]["dense0"])
        _bn(sd, f"{pre}.backbone.batchnorm", dp[g]["backbone"]["bn0"], ds[g]["backbone"]["bn0"])
        _dense(sd, f"{pre}.mdn.pi.conv", dp[g]["pi"])
        sd[f"{pre}.mdn.mu"] = np.asarray(dp[g]["mu"])
        sd[f"{pre}.mdn.log_sigma"] = np.asarray(dp[g]["log_sigma"])

    return {k: torch.from_numpy(np.array(v, dtype=np.float32)) for k, v in sd.items()}


def _normalized(own, state_dict):
    """A reference-layout state_dict with DataParallel ``module.`` prefixes
    stripped, the graph buffer ``A`` and BatchNorm ``num_batches_tracked``
    dropped (architecture constants and torch bookkeeping), and 1x1 conv
    weights stored with trailing unit dims (the reference's (out, in, 1[, 1]))
    reshaped to the port's shapes in ``own``."""
    sd = {}
    for k, v in state_dict.items():
        k = k[len("module."):] if k.startswith("module.") else k
        if k.endswith(_BUFFERS) or k.split(".")[-1] == "A":
            continue
        v = torch.as_tensor(np.asarray(v) if not torch.is_tensor(v) else v)
        if k in own and v.shape != own[k].shape and v.numel() == own[k].numel():
            v = v.reshape(own[k].shape)
        sd[k] = v
    return sd


def load_reference_state_dict(model, state_dict):
    """Load a reference-layout state_dict (a checkpoint of the reference
    P2RNet or of this port) into ``model`` with strict key checking, after
    ``_normalized``'s prefix, buffer and shape handling."""
    model.load_state_dict(_normalized(model.state_dict(), state_dict), strict=True)
    return model


def load_partial_state_dict(model, state_dict, log=print):
    """Finetune load (JAX train/checkpoint.py:73-102, the reference's
    parse_state_dict): after ``_normalized``'s handling, copy each tensor
    whose key and shape match ``model``'s, log ``skip weight <key> (missing
    or shape mismatch)`` for every other tensor of ``state_dict``, and
    ``partial weight load: n/m tensors`` when fewer than all m of the model's
    tensors were loaded.  Returns the number loaded."""
    own = model.state_dict()
    merged = dict(own)
    n_hit = 0
    for k, v in _normalized(own, state_dict).items():
        if k in own and v.shape == own[k].shape:
            merged[k] = v
            n_hit += 1
        else:
            log(f"skip weight {k} (missing or shape mismatch)")
    if n_hit < len(own):
        log(f"partial weight load: {n_hit}/{len(own)} tensors")
    model.load_state_dict(merged, strict=True)
    return n_hit
