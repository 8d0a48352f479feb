"""nlspn_serve_roofline: the served NLSPN kernels' (#1
``shift_mask_scatter.cu``, #3 ``nlspn_propagate.cu``) least time for the
slice's requests over their device time there
(``roofline/nlspn_serve.py``)."""


def read(ctx):
    if ctx.spec.traffic["driver"] != "serve":
        return None
    return ctx.roofline_pct("nlspn_serve")
