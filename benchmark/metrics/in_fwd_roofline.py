"""in_fwd_roofline: the instance-norm forward kernel's (#7,
``csrc/instance_norm.cu``) least time for the slice's requests over its
device time there (``roofline/in_fwd.py``)."""


def read(ctx):
    return ctx.roofline_pct("in_fwd")
