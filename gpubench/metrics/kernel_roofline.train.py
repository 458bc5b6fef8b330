"""The port's kernels' share of their roofline in a training step: the sum over
their calls of each call's bound (``roofline.ops_of_step``) over their
device time."""


def read(r):
    return r.kernel_roofline()
