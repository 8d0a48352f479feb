"""stall_pct.serve: the share of the traced slice's time in which the
device ran nothing while the host was inside the program's served call
(its span ``rdfc.serve``). ``idle_pct.serve`` less this is the idle time
outside the program: the harness's input copy, the readback, the loop."""

from harness import spans


def read(ctx):
    sl = spans.serve_slice(ctx)
    us = None if sl is None else spans.stall_us(sl, "rdfc.serve")
    return None if us is None else 1e-4 * us / sl.window_s
