"""Model FLOPs a second over the serving window (``roofline.flops``: the eval
forward at the bucket's shape) as a share of the float32 peak."""


def read(r):
    return r.mfu()
