"""Device time of one call on the CUDA card: the port's counterpart of the
JAX package's ``bench.measure``, timed as ``chip_smoke.py`` times kernels.

``calls`` back-to-back calls are captured in one CUDA graph after a
warm-up; the graph is replayed ``rounds`` times between two CUDA events,
and the median replay's time over ``calls`` is the result. Replays carry no
host launch cost, so this is the device's time. There is no CPU
counterpart: on a CPU tensor or without a card it raises.
"""

from __future__ import annotations

from typing import Callable

import torch


def measure(fn: Callable[[], object], calls: int = 8, warmup: int = 2,
            rounds: int = 5) -> float:
    """Seconds of device time per call of ``fn``, which takes no arguments
    and runs on the current CUDA device."""
    if not torch.cuda.is_available():
        raise RuntimeError("measure needs a CUDA card")
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):   # a warm-up off the default stream
        fn()
    torch.cuda.current_stream().wait_stream(stream)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    times = []
    for _ in range(rounds):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / 1e3 / calls)
    return sorted(times)[rounds // 2]
