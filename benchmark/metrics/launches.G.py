"""launches.G: kernel launch calls a request that the host made inside the
program's span ``rdfc.G`` (the RDF-GAN's one served net; the traced
slice)."""

from harness import spans


def read(ctx):
    return spans.per_request(ctx, spans.launch_calls, "rdfc.G")
