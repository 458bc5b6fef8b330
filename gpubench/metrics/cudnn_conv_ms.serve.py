"""Device milliseconds a request in cuDNN's convolution kernels, BatchNorm
apart. Where requests come back to back."""


def read(r):
    return r.device_ms("conv")
