"""Process start to the port imported, its libraries loaded and CUDA
initialised."""


def read(ctx):
    return ctx["startup_s"]
