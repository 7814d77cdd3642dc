"""Work counts and the card's published peaks: the yardstick of the
roofline and MFU metrics.

Peaks: NVIDIA's H100 SXM data sheet (dense): 67 TFLOP/s f32 on the CUDA
cores, 495 TFLOP/s TF32 on the tensor cores, 3.35 TB/s HBM3; the bound
arithmetic is ``chip_smoke.py``'s (``bound_ms`` / ``tc_bound_ms``): the
larger of the bytes at the memory rate and the operations at the kernel's
rate, where an f32 product on the tensor cores is three TF32 products
(3xTF32, the fastest the card takes f32 operands at f32 accuracy).

Operations are those the layer equations need on the cell's shapes,
whatever implements them: multiply-adds of the products count 2, the
elementwise work around them is not counted.  The ST-GCN graph convolution
counts as published: the 1x1 convolution to K partitions (2 V C K C a
frame) and the contraction with the adjacency over its 971 nonzero
entries (2 nnz C a frame), 4.90 MFLOP a frame, less than the folded
product over its nonzero joint blocks (7.95) or the dense fold (98), so
no implementation of it reads above 100%.  A train step counts the
forward once and the backward once (an input gradient and a weight
gradient per product, no input gradient into the data), no recompute.
"""

PEAK_F32_FLOPS = 67e12
PEAK_TF32_FLOPS = 495e12
PEAK_BYTES = 3.35e12
F32_TC_RATE = PEAK_TF32_FLOPS / 3  # 3xTF32: three tensor-core products a product


def bound_s(flops, nbytes, rate):
    """The least time of a call: the larger of bytes at the memory rate
    and operations at ``rate``."""
    return max(nbytes / PEAK_BYTES, flops / rate)


def shape_of(model, batch):
    """The shapes the counts read, from a configuration's ``model``."""
    return {
        "B": batch, "T": model["num_frames"], "V": model["num_joints"], "C": model["channels"],
        "K": model["partitions"], "nnz": model["adjacency_nonzeros"], "S": model["num_seeds"],
        "P": model["num_proposals"], "G": model["num_gaussian"], "classes": model["num_class"],
        "knn": model["window"], "nsample": model["ball_samples"],
    }


def products(s):
    """Every product of one clip's forward: (name, rows, in, out, input
    gradient needed)."""
    T, V, C, S, P, G = s["T"], s["V"], s["C"], s["S"], s["P"], s["G"]
    out = [("pos_embed.0", T * s["knn"], 3, 64, False), ("pos_embed.1", T * s["knn"], 64, 64, True),
           ("pos_embed.2", T * s["knn"], 64, C, True),
           ("sk_feat.0", T * V, 3, 64, False), ("sk_feat.1", T * V, 64, 64, True),
           ("sk_feat.2", T * V, 64, C, True)]
    for b in range(6):
        out += [(f"block{b}.gcn", T * V, C, s["K"] * C, True),
                (f"block{b}.adjacency", T * C, s["nnz"], 1, True),
                (f"block{b}.tcn", T * V, 3 * C, C, True)]
    out += [("conv_joint", T, V * C, 256, True),
            ("vote.0", S, 256, 256, True), ("vote.1", S, 256, 256, True), ("vote.2", S, 256, 259, True),
            ("aggregation.0", P * s["nsample"], 256, 256, True),
            ("aggregation.1", P * s["nsample"], 256, 256, True)]
    for head, d in (("center", 3), ("size", 3), ("heading", 2)):
        out += [(f"{head}.0", P, 256, 128, True), (f"{head}.1", P, 128, 128, True),
                (f"gmm_{head}.backbone", P, 128, 128, True), (f"gmm_{head}.pi", P, 128, G, True),
                (f"gmm_{head}.mean", P, G, d, True)]
    out += [("sem_obj.0", P, 256, 128, True), ("sem_obj.1", P, 128, 128, True),
            ("sem_obj.2", P, 128, 2 + s["classes"], True)]
    return out


def forward_flops(s):
    """Operations of one clip's forward pass."""
    return sum(2 * rows * i * o for _, rows, i, o, _ in products(s))


def train_flops(s):
    """Operations of one clip's share of a train step: the forward, then a
    weight gradient for every product and an input gradient where the
    input is not data."""
    fwd = sum(2 * rows * i * o for _, rows, i, o, _ in products(s))
    bwd = sum(2 * rows * i * o * (2 if dx else 1) for _, rows, i, o, dx in products(s))
    return fwd + bwd
