"""peak_mem_gib: the device's peak of allocated memory over the window
(``torch.cuda.max_memory_allocated`` after a reset at its start), GiB."""


def read(ctx):
    b = ctx.window.get("peak_bytes", 0)
    return b / 2 ** 30 if b else None
