"""Device milliseconds a request in cuDNN's convolution kernels, BatchNorm
apart, read over requests sent back to back after the window (the
window's come at the traffic's rate)."""


def read(r):
    return r.device_ms("conv")
