"""Device milliseconds a training step in the port's own kernels."""


def read(r):
    return r.device_ms("port")
