"""The card's allocated-memory peak over the window (reset at its start)."""


def read(w):
    return w.peak_bytes / 2**30 if w.peak_bytes else None
