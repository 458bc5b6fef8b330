"""Share of the profiled serving sub-window with nothing on the device, read
over requests sent back to back after the window (the window's come at
the traffic's rate): the share of a request in which the device waits on
the host, not the idle share of the stream."""


def read(r):
    return r.idle_share()
