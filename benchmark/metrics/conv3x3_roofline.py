"""conv3x3_roofline: the bf16 conv-block kernels' (#9 / #10,
``csrc/conv3x3_bf16.cu``) least time for the slice's steps over their
device time there (``roofline/conv3x3.py``)."""


def read(ctx):
    return ctx.roofline_pct("conv3x3")
