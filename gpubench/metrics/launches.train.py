"""Kernel launches a training step."""


def read(r):
    return r.launches()
