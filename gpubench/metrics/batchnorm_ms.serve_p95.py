"""Device milliseconds a request in BatchNorm's kernels, read over requests
sent back to back after the window (the window's come at the traffic's
rate)."""


def read(r):
    return r.device_ms("batchnorm")
