"""Kernel 5 (csrc/stgcn_sparse.cu, the sparse_eval chain): the ST-GCN graph
convolution with BN1 and ReLU.  Counted as the layer's equations need it
(benchmark/harness/work.py): the 1x1 convolution to K partitions and the
adjacency's nonzero entries, whatever tiles the kernel covers; the
activations read and written once, the weights read once; f32 on the
tensor cores as 3xTF32."""

from benchmark.harness.work import F32_TC_RATE


def count(s):
    B, T, V, C, K = s["B"], s["T"], s["V"], s["C"], s["K"]
    return {"flops": B * T * (2 * V * C * K * C + 2 * s["nnz"] * C),
            "bytes": 4 * (2 * B * T * V * C + K * C * C + K * C + s["nnz"] + 2 * V * C),
            "rate": F32_TC_RATE}
