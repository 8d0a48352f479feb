"""stall_ms.G_guidance: ms a request in which the device ran nothing while
the host was inside the program's span ``rdfc.G_guidance`` (the guided
RDF-GAN's ESANet, inside ``rdfc.G``; the traced slice)."""

from harness import spans


def read(ctx):
    return spans.per_request(ctx, spans.stall_us, "rdfc.G_guidance", 1e-3)
