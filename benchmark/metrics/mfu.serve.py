"""mfu.serve: model FLOPs served a second over the window (the
reference's count of one request, on the meta device, times the
requests, over the window's time), as a share of the H100's 67 TFLOP/s
f32 outside the tensor cores: the served path runs f32 with TF32 off."""

from harness.common import PEAK_F32_FLOPS


def read(ctx):
    if ctx.spec.traffic["driver"] != "serve" or not ctx.unit_flops:
        return None
    rate = ctx.unit_flops * ctx.window["units"] / ctx.window["seconds"]
    return 100.0 * rate / PEAK_F32_FLOPS
