"""Device milliseconds a request in the port's own kernels. Where requests come
back to back."""


def read(r):
    return r.device_ms("port")
