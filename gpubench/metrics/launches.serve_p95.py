"""Kernel launches a request, read over requests sent back to back after the
window."""


def read(r):
    return r.launches()
