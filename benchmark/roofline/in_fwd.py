"""The instance-norm forward (#7, ``csrc/instance_norm.cu``) as served: the
four W-AdaIN planes of the RDFGenerator, in f32. Each launch reads x and
writes y once and writes a 4-byte scale a plane; per element its f64 sums
(a convert, an add, a multiply and an add) counted at the f32 rate by the
ratio of the f32 and f64 peaks, and y's multiply and add."""

from harness.common import PEAK_F32_FLOPS, PEAK_F64_FLOPS

KERNELS = r"\binstance_norm_fwd_kernel\b"


def generator_cfg(model: dict) -> dict:
    return model["G"] if model["type"] == "RDFGAN" else model["G_A2B"]


def wadain_planes(g: dict, batch: int, height: int, width: int):
    """(B, C, H, W) of fuse layers 1-4: the deepest encoder level at 1/16,
    then each decoder level with its concat skip, up to 1/2."""
    rce = list(g.get("rgb_channels_encoder", (64, 64, 128, 256, 512, 512)))
    rcd = list(g.get("rgb_channels_decoder", (256, 128, 64, 64)))
    out = []
    for i in range(1, 5):
        c = rce[-1] if i == 1 else rcd[i - 2] + rce[-i]
        s = 2 ** (5 - i)
        out.append((batch, c, -(-height // s), -(-width // s)))
    return out


def work(ctx):
    """(bytes, FLOPs, peak FLOP/s) of each launch of one request."""
    out = []
    for b, c, h, w in wadain_planes(generator_cfg(ctx.spec.config["model"]),
                                    ctx.batch, ctx.height, ctx.width):
        n = b * c * h * w
        out.append((2 * n * 4 + b * c * 4,
                    n * (2.0 + 4.0 * PEAK_F32_FLOPS / PEAK_F64_FLOPS),
                    PEAK_F32_FLOPS))
    return out
