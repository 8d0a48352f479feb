"""launches.G_A2B: kernel launch calls a request that the host made inside
the program's span ``rdfc.G_A2B`` (the traced slice)."""

from harness import spans


def read(ctx):
    return spans.per_request(ctx, spans.launch_calls, "rdfc.G_A2B")
