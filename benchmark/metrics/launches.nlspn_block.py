"""launches.nlspn_block: kernel launch calls a request that the host made inside
the program's span ``rdfc.nlspn_block`` (the traced slice)."""

from harness import spans


def read(ctx):
    return spans.per_request(ctx, spans.launch_calls, "rdfc.nlspn_block")
