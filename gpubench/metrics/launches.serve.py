"""Kernel launches a request. Where requests come back to back."""


def read(r):
    return r.launches()
