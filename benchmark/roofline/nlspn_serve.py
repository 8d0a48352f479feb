"""The served NLSPN kernels: the shift-mask scatter (#1,
``csrc/shift_mask_scatter.cu``: per pixel K = 4 corners x k^2 taps f32
weights and two int32 shifts read, S^2 f32 masks written, one add a
weight) and the propagation chain (#3, ``csrc/nlspn_propagate.cu``: the
S^2 masks in bf16 read, the f32 plane read and written; a multiply and an
add a mask a step, T steps). S = 2R + 4 with the stencil radius R."""

from harness.common import PEAK_F32_FLOPS

KERNELS = r"\b(shift_mask_scatter_kernel|propagate_chain_kernel)\b"
RADIUS = 2


def nlspn(ctx):
    g = ctx.spec.config["model"]["G"]
    n = g.get("nlspn_configs", {})
    k = n.get("prop_kernel", 3)
    return 4 * k * k, 2 * RADIUS + 4, n.get("prop_time", 18)


def work(ctx):
    K, S, T = nlspn(ctx)
    px = ctx.batch * ctx.height * ctx.width
    scatter = (px * (K * (4 + 4 + 4) + S * S * 4), float(px * K),
               PEAK_F32_FLOPS)
    chain = (px * (S * S * 2 + 2 * 4), 2.0 * T * S * S * px,
             PEAK_F32_FLOPS)
    return [scatter, chain]
