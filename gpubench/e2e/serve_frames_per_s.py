"""Frames returned to the client over the window's whole time."""


def read(w):
    return w.frames / w.seconds if w.kind == "serve" and w.seconds > 0 else None
