"""Kernel 4 (csrc/stgcn_train_bwd.cu): the temporal conv's transpose with
the ReLU mask (an input gradient) and its tap gradient (a weight gradient),
with BN1's per-clip column partials.  dy2 and y read, dpre, the partials
and the tap gradient written, f32 on the tensor cores as 3xTF32."""

from benchmark.harness.work import F32_TC_RATE


def count(s):
    rows = s["B"] * s["T"] * s["V"]
    C = s["C"]
    return {"flops": 2 * 2 * 3 * C * C * rows,
            "bytes": 4 * (3 * rows * C + 2 * s["B"] * s["V"] * C + 2 * 3 * C * C + 2 * s["V"] * C),
            "rate": F32_TC_RATE}
