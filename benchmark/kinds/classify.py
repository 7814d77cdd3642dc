"""The ``classify`` kind: a skeleton action classifier's forward (2s-AGCN,
``method: AGCN``, built through the program's ``runners.common.build_model``)
on ``batch`` samples a call, batch after batch from a pinned host pool of
``pool_batches`` batches, closed loop, one client; each batch's logits are
copied back before it counts.  Set-up runs ``warm_batches``; the traced
window runs ``trace_batches``.

Samples are synthetic NTU RGB+D skeletons (``skeletons``), (3, T, 25, 2)
each, T the configuration's ``frames``: a body's drawn walk of
``min_frames`` to T frames, padded to T by repeating it and centred on the
spine joint of the first body, frame by frame, as 2s-AGCN's
data_gen/preprocess.py (pre_normalization) does; in a share ``two_bodies``
of the samples a second body beside the first, otherwise zeros, as NTU
stores one body.

``correct`` compares one window batch, drawn from the seed, with the plain
reference (benchmark/reference/agcn.py) on the same input and weights:
``logit_gap`` (the widest gap of the logits over the reference's largest
|logit|) and ``adj_gap`` (the widest gap of the first unit's C_0, the
softmax map of its first subset, read from the program by
``AGCN.attention``, which the timed path does not call).

``shape()`` gives the shapes the counts read; ``layer_flops`` /
``sample_flops`` count what the layer equations need for one sample
(multiply-adds count 2; BatchNorm, softmax, ReLU and the means are not
counted): 38.81 GFLOP at the published widths, T = 300 and M = 2.
"""

import math
import time

import numpy as np
import torch

from benchmark.harness.cells import span, streams, sync
from benchmark.reference import agcn as ref_agcn
from pose2room_tpu_torch.runners.common import build_model

# a standing body in NTU RGB+D's joint order, metres: x right, y up, z away
REST_POSE = np.array([
    [0.0, 0.0, 0.0], [0.0, 0.28, 0.0], [0.0, 0.62, 0.0], [0.0, 0.78, 0.0],  # spine base, middle, neck, head
    [-0.18, 0.52, 0.0], [-0.22, 0.26, 0.0], [-0.24, 0.02, 0.0], [-0.24, -0.05, 0.0],  # left arm, hand
    [0.18, 0.52, 0.0], [0.22, 0.26, 0.0], [0.24, 0.02, 0.0], [0.24, -0.05, 0.0],  # right arm, hand
    [-0.1, -0.02, 0.0], [-0.1, -0.42, 0.0], [-0.1, -0.8, 0.0], [-0.1, -0.85, 0.08],  # left leg, foot
    [0.1, -0.02, 0.0], [0.1, -0.42, 0.0], [0.1, -0.8, 0.0], [0.1, -0.85, 0.08],  # right leg, foot
    [0.0, 0.52, 0.0],  # spine at the shoulders
    [-0.24, -0.1, 0.0], [-0.21, -0.04, 0.02], [0.24, -0.1, 0.0], [0.21, -0.04, 0.02],  # hand tips, thumbs
])
# how far each joint swings, metres: the limbs' ends most
SWING = np.array([0.01, 0.02, 0.03, 0.04, 0.04, 0.12, 0.2, 0.22, 0.04, 0.12, 0.2, 0.22,
                  0.02, 0.12, 0.18, 0.2, 0.02, 0.12, 0.18, 0.2, 0.03, 0.24, 0.22, 0.24, 0.22])
SPINE = 1  # pre_normalization centres every frame on this joint of the first body


def body(rng, n_frames, origin):
    """(n_frames, 25, 3) one body: the rest pose turned to a drawn heading,
    walking from ``origin`` at a drawn velocity, each joint swinging at the
    body's rate with its own phase and direction, plus sensor noise."""
    a = rng.uniform(0, 2 * np.pi)
    rot = np.array([[np.cos(a), 0, np.sin(a)], [0, 1, 0], [-np.sin(a), 0, np.cos(a)]])
    t = np.arange(n_frames)[:, None, None] / 30.0  # NTU's 30 frames a second
    rate = rng.uniform(0.2, 1.5)
    phase = rng.uniform(0, 2 * np.pi, size=(1, 25, 1))
    direction = rng.randn(1, 25, 3)
    direction /= np.linalg.norm(direction, axis=-1, keepdims=True)
    swing = SWING[None, :, None] * np.sin(2 * np.pi * rate * t + phase) * direction
    velocity = rng.randn(3) * np.array([0.3, 0.02, 0.3])
    path = origin + velocity * t + np.cumsum(rng.randn(n_frames, 1, 3) * 0.005, axis=0)
    return (REST_POSE + swing) @ rot.T + path + rng.randn(n_frames, 25, 3) * 0.01


def skeletons(rng, n, frames, min_frames, two_bodies):
    """(n, 3, frames, 25, 2) float32 samples in the layout 2s-AGCN reads."""
    out = np.zeros((n, 2, frames, 25, 3))
    for i in range(n):
        length = rng.randint(min_frames, frames + 1)
        origin = np.array([rng.uniform(-1, 1), rng.uniform(-0.3, 0.3), rng.uniform(2.5, 4.0)])
        people = [body(rng, length, origin)]
        if rng.rand() < two_bodies:
            people.append(body(rng, length, origin + np.array([rng.uniform(0.5, 1.2), 0.0, 0.0])))
        for p, seq in enumerate(people):
            out[i, p] = np.concatenate([seq] * -(-frames // length))[:frames]  # padded by repeating it
        centre = out[i, 0, :, SPINE:SPINE + 1].copy()
        present = (out[i].sum(-1) != 0)[..., None]
        out[i] = (out[i] - centre) * present
    return np.ascontiguousarray(out.transpose(0, 4, 2, 3, 1), dtype=np.float32)


def reference_model(model_cfg):
    return ref_agcn.Model(num_class=model_cfg["num_class"], num_point=model_cfg["num_point"],
                          num_person=model_cfg["num_person"], in_channels=model_cfg["in_channels"],
                          widths=model_cfg["widths"], strides=model_cfg["strides"],
                          coff_embedding=model_cfg["coff_embedding"],
                          temporal_kernel=model_cfg["temporal_kernel"])


def leaf_shapes(model_cfg):
    with torch.device("meta"):
        ref = reference_model(model_cfg)
    return {k: tuple(v.shape) for k, v in ref.state_dict().items() if not k.endswith("num_batches_tracked")}


def make_weights(shapes, seed, device):
    """Every leaf random, from one standard-normal draw on the device's
    generator: convolutions and the classifier at 1/sqrt(fan_in), biases,
    BN shifts and running means small, running variances near 1, ``PA``
    small beside the graph's entries.  Scaled so that activations stay
    near 1 through the ten units, as trained BN statistics keep them: each
    graph unit's W_k at 1 / (2 sqrt(K C_in)) (it sums K subsets whose
    adjacency columns sum to ~2), BN scales near 0.85.  At 1/sqrt(fan_in)
    and scales near 1 they grow ~3x a unit, the scores of the later units'
    softmax reach ~1e3 and f32 rounding alone moves the logits by up to
    1e-3 of their largest (H100, f32)."""
    gen = torch.Generator(device=device).manual_seed(seed)
    z = torch.randn(sum(math.prod(s) for s in shapes.values()), generator=gen, device=device)
    out, at = {}, 0
    for name, shape in shapes.items():
        n = math.prod(shape)
        x = z[at:at + n].reshape(shape)
        at += n
        if name.endswith("running_var"):
            x = torch.exp(0.2 * x)
        elif name.endswith(("running_mean", ".bias")):
            x = 0.05 * x
        elif name.endswith("PA"):
            x = 0.05 * x
        elif len(shape) == 1:  # a BN scale
            x = 0.85 * (1.0 + 0.1 * x)
        elif ".conv_d." in name:
            unit = name.split(".conv_d.")[0]
            K = sum(k.startswith(unit + ".conv_d.") and k.endswith(".weight") for k in shapes)
            x = x / (2 * math.sqrt(K * n / shape[0]))
        else:
            x = x / math.sqrt(n / shape[0])
        out[name] = x.contiguous()
    return out


def layer_flops(s):
    """Operations of one sample (N = 1, M bodies) by part of the layer
    equations, at the shapes ``s`` (``Traffic.shape``)."""
    M, T, V, K, taps = s["M"], s["T"], s["V"], s["K"], s["taps"]
    parts = dict.fromkeys(("theta_phi", "scores", "aggregation", "w_k", "down", "temporal", "residual",
                           "classifier"), 0)
    c_in = s["C"]
    for i, (c_out, stride) in enumerate(zip(s["widths"], s["strides"])):
        inter = c_out // s["coff"]
        t_out = (T - 1) // stride + 1
        parts["theta_phi"] += 2 * K * 2 * c_in * inter * T * V * M
        parts["scores"] += K * 2 * V * V * inter * T * M
        parts["aggregation"] += K * 2 * V * V * c_in * T * M
        parts["w_k"] += K * 2 * c_in * c_out * T * V * M
        if c_in != c_out:
            parts["down"] += 2 * c_in * c_out * T * V * M
        parts["temporal"] += 2 * c_out * c_out * taps * t_out * V * M
        if i > 0 and (c_in != c_out or stride != 1):
            parts["residual"] += 2 * c_in * c_out * t_out * V * M
        c_in, T = c_out, t_out
    parts["classifier"] = 2 * c_in * s["classes"]
    return parts


def sample_flops(s):
    return sum(layer_flops(s).values())


class Traffic:
    def __init__(self, cell, seed, device):
        t, self.model_cfg, self.device = cell.traffic, cell.config["model"], device
        st = streams(seed)
        self.batch = B = t["batch"]
        pool = torch.from_numpy(skeletons(np.random.RandomState(st["scenes"]), t["pool_batches"] * B,
                                          self.model_cfg["frames"], t["min_frames"], t["two_bodies"]))
        self.pool = pool.pin_memory() if device.type == "cuda" else pool
        self.n_batches = t["pool_batches"]
        self.weights = make_weights(leaf_shapes(self.model_cfg), st["weights"], device)
        self.model = build_model({"method": "AGCN", "model": self.model_cfg}, device=device)
        self.model.load_state_dict(self.weights, strict=True)
        self.sample_seed = st["sample"]
        self.traffic = t
        self.calls = 0
        self.kept = []
        self.checked = None

    def shape(self):
        m = self.model_cfg
        return {"N": self.batch, "M": m["num_person"], "T": m["frames"], "V": m["num_point"],
                "C": m["in_channels"], "widths": list(m["widths"]), "strides": list(m["strides"]),
                "K": m["subsets"], "coff": m["coff_embedding"], "taps": m["temporal_kernel"],
                "classes": m["num_class"]}

    def step(self):
        """One batch from issue to its logits on the host: (pool batch,
        logits, seconds)."""
        k = self.calls % self.n_batches
        self.calls += 1
        t0 = time.perf_counter()
        with span("h2d"):
            x = self.batch_of(k).to(self.device, non_blocking=True)
        with span("classify"), torch.no_grad():
            logits = self.model(x)
        with span("d2h"):
            out = logits.cpu()
        return k, out, time.perf_counter() - t0

    def warm(self):
        for _ in range(self.traffic["warm_batches"]):
            self.step()
        self.finish()

    def finish(self):
        sync(self.device)

    def window(self, seconds):
        times, ends = [], []
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            k, out, dt = self.step()
            times.append(dt)
            ends.append(time.perf_counter() - t0)
            self.kept.append((k, out))
        elapsed = time.perf_counter() - t0
        return {"items": len(times) * self.batch, "iterations": len(times), "seconds": elapsed,
                "batch_seconds": times, "ends": ends}

    def traced(self):
        n = self.traffic["trace_batches"]
        for _ in range(n):
            self.step()
        return n

    def close(self):
        """The compared batch, drawn from the seed, and the program's C_0 for
        it; then the program's state is freed."""
        k, out = self.kept[np.random.RandomState(self.sample_seed).randint(len(self.kept))]
        with torch.no_grad():
            att = self.model.attention(self.batch_of(k).to(self.device))[:, 0].cpu()
        self.checked = (k, out, att)
        self.kept = []
        del self.model

    def batch_of(self, k):
        return self.pool[k * self.batch:(k + 1) * self.batch]

    def numbers(self):
        k, out, att = self.checked
        return classify_numbers(self.model_cfg, self.weights, self.batch_of(k), out, att, self.device)


def reference_outputs(model_cfg, weights, x, device):
    """The reference's logits and first-unit C_0 on ``x``, at the precision
    the caller set."""
    ref = ref_agcn.load(reference_model(model_cfg).to(device), weights).eval()
    with torch.no_grad():
        logits = ref(x.to(device))
    return logits, ref.l1.gcn1.attention[:, 0]


def classify_numbers(model_cfg, weights, x, logits, att, device):
    """``logit_gap`` and ``adj_gap`` of the program's ``logits`` and C_0
    ``att`` for the batch ``x`` against the reference in f32."""
    ref_agcn.set_precision(tf32=False)
    want, want_att = reference_outputs(model_cfg, weights, x, device)
    return {"logit_gap": float((logits.to(device) - want).abs().max() / want.abs().max()),
            "adj_gap": float((att.to(device) - want_att).abs().max()),
            "logit_max": float(want.abs().max())}


def control_numbers(cell, seed, device):
    """The control: the reference with TF32 on put in the program's place,
    on the cell's first pool batch, judged by the same comparison."""
    traffic = Traffic(cell, seed, device)
    del traffic.model
    x = traffic.batch_of(0)
    try:
        ref_agcn.set_precision(tf32=True)
        logits, att = reference_outputs(traffic.model_cfg, traffic.weights, x, device)
    finally:
        ref_agcn.set_precision(tf32=False)
    return classify_numbers(traffic.model_cfg, traffic.weights, x, logits, att, device)
