"""Device time of each call on the CUDA card, from CUDA events: the port's
counterpart of the JAX package's ``utils/device_time.py``.

Each call runs between its own pair of CUDA events on the current stream,
so its duration is the card's, not the host's. The events and the calls
are queued behind a spin kernel (``torch.cuda._sleep``) that keeps the
card busy while the host enqueues them, so no host launch gap falls between
a call's two events, as none falls inside the JAX version's profiler
events. There is no CPU counterpart: without a card, or on CPU tensors,
both functions raise.
"""

from __future__ import annotations

from typing import Callable, List

import torch

# Cycles of the spin kernel queued before the timed calls: about 25 ms at
# the H100's 1.98 GHz boost clock, longer than the host takes to enqueue them.
SPIN_CYCLES = 50_000_000


def _check_card(args) -> None:
    if not torch.cuda.is_available():
        raise RuntimeError("device time needs a CUDA card")
    for a in args:
        if isinstance(a, torch.Tensor) and not a.is_cuda:
            raise ValueError(f"device time of a call on a {a.device} tensor: "
                             "want CUDA tensors")


def device_durations_us(fn: Callable, *args, calls: int = 8,
                        warmup: int = 2) -> List[float]:
    """Run ``fn(*args)`` ``warmup`` times, then ``calls`` times back to
    back, each between two CUDA events; return the calls' device durations
    in microseconds, sorted.

    ``fn`` should chain its own state if calls depend on each other; the
    stream runs the calls in the order they were enqueued.
    """
    _check_card(args)
    for _ in range(warmup):
        fn(*args)
    torch.cuda.synchronize()
    events = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
              for _ in range(calls)]
    torch.cuda._sleep(SPIN_CYCLES)
    for start, end in events:
        start.record()
        fn(*args)
        end.record()
    torch.cuda.synchronize()
    return sorted(1e3 * start.elapsed_time(end) for start, end in events)


def median_device_time_s(fn: Callable, *args, calls: int = 8,
                         warmup: int = 2) -> float:
    """Median per-call device time in seconds."""
    durs = device_durations_us(fn, *args, calls=calls, warmup=warmup)
    return durs[len(durs) // 2] / 1e6
