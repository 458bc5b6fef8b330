"""Host milliseconds a request in ``Predictor.make_sample`` (normalise, pad,
stack, copy to the card), from the harness's span around the instance's
method over the window, where requests come at the traffic's rate."""


def read(r):
    return r.span_ms("make_sample")
