"""stall_ms.G: ms a request in which the device ran nothing while the host
was inside the program's span ``rdfc.G`` (the RDF-GAN's one served net; the
traced slice)."""

from harness import spans


def read(ctx):
    return spans.per_request(ctx, spans.stall_us, "rdfc.G", 1e-3)
