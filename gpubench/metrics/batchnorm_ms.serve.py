"""Device milliseconds a request in BatchNorm's kernels. Where requests come
back to back."""


def read(r):
    return r.device_ms("batchnorm")
