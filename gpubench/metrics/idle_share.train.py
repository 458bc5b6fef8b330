"""Share of the profiled training sub-window with nothing on the device."""


def read(r):
    return r.idle_share()
