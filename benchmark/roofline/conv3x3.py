"""The bf16 conv-block kernels (#9 forward, #10 backward,
``csrc/conv3x3_bf16.cu``) of one train step: two 3x3 C -> C convolutions
of each identity BasicBlock of the generator's two resnet18 torsos, each
G forward of the step. A forward launch: 18 B H W C^2 FLOPs, x read and
y written in bf16 and the f32 weights read; a backward launch: the data
and weight gradients, 36 B H W C^2 FLOPs, dy, x and y read, dx written,
dW written in f32."""

from harness.common import PEAK_BF16_FLOPS

KERNELS = (r"\b(to_nhwc_kernel|conv_kernel|reduce_tiles_kernel|"
           r"wgrad_kernel|wgrad_reduce_kernel|pack_kernel)\b")


def identity_planes(enc, in_channels: int, height: int, width: int):
    """(C, H, W) of each identity block of a resnet18 torso: layer 1 (both
    blocks where its input width matches) at the full size behind the
    stride-1 first conv, the second block of layers 2-4 at 1/2, 1/4,
    1/8."""
    out = []
    if in_channels == enc[0]:
        out.append((enc[0], height, width))
    out.append((enc[0], height, width))
    for i, c in enumerate(enc[1:4], start=1):
        s = 2 ** i
        out.append((c, -(-height // s), -(-width // s)))
    return out


def work(ctx):
    model = ctx.spec.config["model"]
    if model["type"] == "RDFGAN":
        g, passes = model["G"], 1
    else:
        g, passes = model["G_A2B"], 2
    rce = list(g.get("rgb_channels_encoder", (64, 64, 128, 256, 512, 512)))
    dce = list(g.get("depth_channels_encoder", rce))
    planes = identity_planes(rce[1:], rce[0], ctx.height, ctx.width) + \
        identity_planes(dce[1:], 64, ctx.height, ctx.width)
    B = ctx.batch
    out = []
    for c, h, w in planes:
        act = B * c * h * w * 2
        wts = 9 * c * c
        fwd = (2 * act + wts * 4, 18.0 * B * h * w * c * c, PEAK_BF16_FLOPS)
        bwd = (4 * act + wts * 4, 36.0 * B * h * w * c * c, PEAK_BF16_FLOPS)
        out += [fwd, fwd, bwd, bwd] * passes
    return out
