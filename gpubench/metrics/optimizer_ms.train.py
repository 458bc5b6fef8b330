"""Device milliseconds a training step in Adam's kernels."""


def read(r):
    return r.device_ms("optimizer")
