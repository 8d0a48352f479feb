"""train_img_s: images trained over the window's whole time (host
clock, the device synchronised at its end)."""


def read(ctx):
    if ctx.spec.traffic["driver"] != "train":
        return None
    return ctx.window["images"] / ctx.window["seconds"]
