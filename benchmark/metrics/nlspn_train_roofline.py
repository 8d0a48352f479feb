"""nlspn_train_roofline: the trained NLSPN kernels' (#1, #2, #4, #5,
#6) least time for the slice's steps over their device time there
(``roofline/nlspn_train.py``)."""


def read(ctx):
    if ctx.spec.traffic["driver"] != "train":
        return None
    return ctx.roofline_pct("nlspn_train")
