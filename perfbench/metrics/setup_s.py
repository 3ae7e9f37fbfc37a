"""Set-up: process start to the first timed work (imports, weights, the
scan's rendering, the warm-up), by the host's clock."""


def read(ctx):
    return ctx["setup_s"]
