"""Model FLOPs a second over the training window (``roofline.flops``: forward
and backward, nothing recomputed) as a share of the float32 peak."""


def read(r):
    return r.mfu()
