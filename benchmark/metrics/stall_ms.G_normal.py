"""stall_ms.G_normal: ms a request in which the device ran nothing while the
host was inside the program's span ``rdfc.G_normal`` (the traced slice)."""

from harness import spans


def read(ctx):
    return spans.per_request(ctx, spans.stall_us, "rdfc.G_normal", 1e-3)
