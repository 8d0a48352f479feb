"""graph_hit_pct.serve: the share of the served nets' runs in the traced
slice that replayed a CUDA graph: 100 x the program's ``rdfc.graph_replay``
spans over its ``rdfc.G_label``, ``rdfc.G_normal`` and ``rdfc.G_A2B`` spans
there. None where the slice holds no replay span (a program that replays
none)."""

from harness import spans

NETS = ("rdfc.G_label", "rdfc.G_normal", "rdfc.G_A2B")
REPLAY = "rdfc.graph_replay"


def read(ctx):
    sl = spans.serve_slice(ctx)
    if sl is None:
        return None
    names = [n for n, _, _ in sl.host]
    replays = names.count(REPLAY)
    nets = sum(names.count(n) for n in NETS)
    return 100.0 * replays / nets if replays and nets else None
