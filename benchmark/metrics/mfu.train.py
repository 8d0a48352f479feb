"""mfu.train: model FLOPs trained a second over the window (the
reference's count of one step's forwards and backwards, on the meta
device, times the steps, over the window's time), as a share of the
H100's 989 TFLOP/s bf16: the step runs under bf16 autocast."""

from harness.common import PEAK_BF16_FLOPS


def read(ctx):
    if ctx.spec.traffic["driver"] != "train" or not ctx.unit_flops:
        return None
    rate = ctx.unit_flops * ctx.window["units"] / ctx.window["seconds"]
    return 100.0 * rate / PEAK_BF16_FLOPS
