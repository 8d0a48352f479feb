"""stall_ms.nlspn_block: ms a request in which the device ran nothing while the
host was inside the program's span ``rdfc.nlspn_block`` (the traced slice)."""

from harness import spans


def read(ctx):
    return spans.per_request(ctx, spans.stall_us, "rdfc.nlspn_block", 1e-3)
