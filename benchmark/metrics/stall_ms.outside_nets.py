"""stall_ms.outside_nets: ms a request in which the device ran nothing
while the host was inside the program's served call (``rdfc.serve``) but
in none of its nets' spans: the engine's own code around the nets, such as
the walk that puts every module in eval mode (the traced slice)."""

from harness import spans

NETS = ("rdfc.G_label", "rdfc.G_normal", "rdfc.G_A2B", "rdfc.G")


def read(ctx):
    return spans.per_request(ctx, spans.stall_outside_us, "rdfc.serve",
                             1e-3, NETS)
