"""Device milliseconds a training step in cuDNN's convolution kernels,
BatchNorm apart."""


def read(r):
    return r.device_ms("conv")
