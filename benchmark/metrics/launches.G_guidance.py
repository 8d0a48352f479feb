"""launches.G_guidance: kernel launch calls a request that the host made
inside the program's span ``rdfc.G_guidance`` (the guided RDF-GAN's
ESANet, inside ``rdfc.G``; the traced slice)."""

from harness import spans


def read(ctx):
    return spans.per_request(ctx, spans.launch_calls, "rdfc.G_guidance")
