"""Device milliseconds a training step in BatchNorm's kernels."""


def read(r):
    return r.device_ms("batchnorm")
