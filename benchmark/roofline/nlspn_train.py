"""The trained NLSPN kernels of one bf16 step: the scatter (#1; bf16
weights, int32 shifts, bf16 masks), the gather of dM back to the
weights (#2; S^2 bf16 dM read, the shifts read, bf16 weights written),
the forward chain that stores its T planes (#4), the transposed chain
(#5; masks, two planes and the T-plane bf16 stack) and the shift
correlation (#6; two stacks read, S^2 bf16 dM written): PERF.md's
per-kernel counts, each input read once and each output written once."""

from harness.common import PEAK_F32_FLOPS

KERNELS = (r"\b(shift_mask_scatter_kernel|shift_mask_gather_kernel|"
           r"propagate_chain_kernel|reverse_chain_kernel|corr_kernel)\b")
RADIUS = 2


def work(ctx):
    g = ctx.spec.config["model"]["G"]
    n = g.get("nlspn_configs", {})
    k = n.get("prop_kernel", 3)
    T = n.get("prop_time", 18)
    S = 2 * RADIUS + 4
    K = 4 * k * k
    px = ctx.batch * ctx.height * ctx.width
    plane, stack, masks = px * 4, T * px * 2, px * S * S * 2
    chain_ops = 2.0 * T * S * S * px
    f = PEAK_F32_FLOPS
    return [(px * (K * (2 + 4 + 4)) + masks, float(px * K), f),
            (masks + px * K * (4 + 4 + 2), float(px * K), f),
            (masks + 2 * plane + stack, chain_ops, f),
            (masks + 2 * plane + stack, chain_ops, f),
            (2 * stack + masks, chain_ops, f)]
