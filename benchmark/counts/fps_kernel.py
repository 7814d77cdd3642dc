"""Kernel 2 (csrc/fps.cu): furthest point sampling of P proposals from S
votes a clip.  Each pick updates every point's distance: 3 subtractions,
3 multiplications, 2 additions and a minimum, on the f32 CUDA cores; the
votes read once, the picks written."""

from benchmark.harness.work import PEAK_F32_FLOPS


def count(s):
    return {"flops": 9 * s["B"] * s["S"] * s["P"],
            "bytes": 4 * s["B"] * (3 * s["S"] + s["P"]),
            "rate": PEAK_F32_FLOPS}
