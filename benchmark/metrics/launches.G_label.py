"""launches.G_label: kernel launch calls a request that the host made inside
the program's span ``rdfc.G_label`` (the traced slice)."""

from harness import spans


def read(ctx):
    return spans.per_request(ctx, spans.launch_calls, "rdfc.G_label")
