"""From the process's start to the first timed step or request: imports, kernel
builds where the checkout has none, weights, inputs, warm-up."""


def read(w):
    return w.setup_s
