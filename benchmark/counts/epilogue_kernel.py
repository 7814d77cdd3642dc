"""Kernel 1 (csrc/stgcn_epilogue.cu, eval chain): the temporal conv, BN2,
the residual and ReLU of one ST-GCN block.  One launch, the mean over a
generate's six (block 0 has no residual): three (C, C) taps a joint and
frame; t1 and the residual read, the output written, f32, on the tensor
cores as 3xTF32."""

from benchmark.harness.work import F32_TC_RATE


def count(s):
    rows = s["B"] * s["T"] * s["V"]
    act = 4 * rows * s["C"]
    return {"flops": 2 * 3 * s["C"] * s["C"] * rows,
            "bytes": act * (2 + 5 / 6) + 4 * (3 * s["C"] * s["C"] + 2 * s["V"] * s["C"]),
            "rate": F32_TC_RATE}
