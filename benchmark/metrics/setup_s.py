"""setup_s: seconds from the start of the process to the start of the
window (imports, the card, kernels found or built, scenes, weights, the
first steps or batches), by the host clock."""


def read(ctx):
    return ctx["setup_s"]
