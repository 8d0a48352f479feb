"""setup_s: seconds from the process's start to the window's start
(host clock): loading, weights and inputs from the seed, the kernels
built or loaded, the warm-up."""


def read(ctx):
    return ctx.setup_s
