"""launch_api_pct.serve: the host's time in kernel launch calls (the CUDA
runtime's and driver's) inside the program's served call (``rdfc.serve``),
over that span's host time in the traced slice: the driver's share of the
call, against Python's and the dispatcher's."""

from harness import spans


def read(ctx):
    sl = spans.serve_slice(ctx)
    launch = None if sl is None else spans.launch_us(sl, "rdfc.serve")
    if launch is None:
        return None
    return 100.0 * launch / spans.host_us(sl, "rdfc.serve")
