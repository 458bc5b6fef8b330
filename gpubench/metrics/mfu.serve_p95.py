"""A request's model FLOPs (``roofline.flops``: the eval forward at the
bucket's shape) over its median latency, as a share of the float32 peak,
where requests come at the traffic's rate."""


def read(r):
    return r.mfu()
