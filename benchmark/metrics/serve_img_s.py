"""serve_img_s: images served over the window's whole time (host
clock)."""


def read(ctx):
    if ctx.spec.traffic["driver"] != "serve":
        return None
    return ctx.window["images"] / ctx.window["seconds"]
