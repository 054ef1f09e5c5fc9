"""Process start to window start: start-up, inputs, the warm pass."""


def read(ctx):
    return ctx["setup_s"]
