"""Kernel 3 (csrc/stgcn_train_fwd.cu): BN1's affine and ReLU, the temporal
conv and its bias, and the per-clip column moments of its output.  Three
(C, C) taps a joint and frame; y read, y2 and the moments written, f32 on
the tensor cores as 3xTF32."""

from benchmark.harness.work import F32_TC_RATE


def count(s):
    rows = s["B"] * s["T"] * s["V"]
    return {"flops": 2 * 3 * s["C"] * s["C"] * rows,
            "bytes": 4 * (2 * rows * s["C"] + 2 * s["B"] * s["V"] * s["C"]
                          + 3 * s["C"] * s["C"] + 3 * s["V"] * s["C"]),
            "rate": F32_TC_RATE}
