"""Share of the profiled serving sub-window with nothing on the device. Where
requests come back to back."""


def read(r):
    return r.idle_share()
