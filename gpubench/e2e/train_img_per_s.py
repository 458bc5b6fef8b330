"""Training images of the optimizer steps completed in the window, over the
window's whole time (it ends on a synchronise after the last step)."""


def read(w):
    return w.images / w.seconds if w.kind == "train" and w.seconds > 0 else None
