"""What a traced run reads: host-clock spans around the calls into the
port's layers, and the device's activity from ``torch.profiler`` over a
steady sub-window after the measured one (one call under the profiler
first, left out, so that its start is not read as the cell's).

Kernels are told apart by name: the port's own are the ``__global__``
functions of its ``csrc/`` sources (found there, so that a kernel a later
change adds is counted too); BatchNorm's (cuDNN's and PyTorch's) by
``bn_`` / ``batch_norm``; cuDNN's convolutions by the fragments its
kernels carry (``conv``, ``gemm``, ``xmma``, ``sm90``, ``wgrad``,
``dgrad``, ``winograd``, ``fft``, ``cudnn``, ``implicit``); Adam's by
``multi_tensor_apply`` (the foreach optimizer) or ``adam``. Nothing is
written to disk: the readings and the breakdown go into the result line.
"""

from __future__ import annotations

import bisect
import functools
import os
import re
import time
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

CONV_FRAGMENTS = ("conv", "cudnn", "implicit", "gemm", "sm90", "xmma", "wgrad",
                  "dgrad", "winograd", "fft")
SPAN_PREFIX = "gpubench."


class Spans:
    """Host-clock spans: total seconds and calls by name."""

    def __init__(self):
        self.total = defaultdict(float)
        self.calls = defaultdict(int)

    def wrap(self, obj, attr: str, name: str) -> None:
        """Time every call of ``obj.attr`` (an instance's bound method) as
        the span ``name``, and mark it for the profiler."""
        import torch

        inner = getattr(obj, attr)

        @functools.wraps(inner)
        def timed(*args, **kwargs):
            with torch.profiler.record_function(SPAN_PREFIX + name):
                t0 = time.perf_counter()
                try:
                    return inner(*args, **kwargs)
                finally:
                    self.total[name] += time.perf_counter() - t0
                    self.calls[name] += 1

        setattr(obj, attr, timed)

    def mean_ms(self, name: str) -> Optional[float]:
        n = self.calls.get(name, 0)
        return 1e3 * self.total[name] / n if n else None


def port_kernel_names(csrc: str) -> frozenset:
    """The ``__global__`` functions of the port's CUDA sources."""
    bounds = r"(?:__launch_bounds__\s*\((?:[^()]|\([^()]*\))*\)\s*)?"
    pat = re.compile(r"__global__\s+" + bounds + r"(?:static\s+)?void\s+" + bounds + r"(\w+)\s*\(")
    names = set()
    for f in sorted(os.listdir(csrc)):
        if f.endswith((".cu", ".cuh")):
            with open(os.path.join(csrc, f)) as fh:
                names.update(pat.findall(fh.read()))
    return frozenset(names)


def bare_name(kernel: str) -> str:
    """A demangled kernel name's function, without return type, namespaces,
    template arguments or parameters: ``void bwd::wgrad_s2_kernel<float>(...)``
    and ``(anonymous namespace)::dec_aff_tail_kernel<8, 2>(...)`` give
    ``wgrad_s2_kernel`` and ``dec_aff_tail_kernel``."""
    head = kernel.replace("(anonymous namespace)::", "").split("(", 1)[0]
    depth, out = 0, []
    for ch in head:
        if ch == "<":
            depth += 1
        elif ch == ">":
            depth -= 1
        elif depth == 0:
            out.append(ch)
    head = "".join(out).strip().split(" ")[-1]
    return head.rsplit("::", 1)[-1]


def group_of(kernel: str, port: frozenset) -> str:
    if bare_name(kernel) in port:
        return "port"
    low = kernel.lower()
    if "bn_" in low or "batch_norm" in low or "batchnorm" in low:
        return "batchnorm"
    if "multi_tensor_apply" in low or "adam" in low:
        return "optimizer"
    if any(s in low for s in CONV_FRAGMENTS):
        return "conv"
    return "other"


def _union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    merged: List[Tuple[float, float]] = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1] = (merged[-1][0], max(merged[-1][1], b))
        else:
            merged.append((a, b))
    return merged


class DeviceTrace:
    """The device's activity over a profiled sub-window of ``units`` steps
    or requests: kernels [(name, start_us, end_us)], copies and memsets
    [(start_us, end_us)], host events [(name, start_us, end_us)] and the
    sub-window [start_us, end_us] on the profiler's clock."""

    def __init__(self, kernels, copies, host, window, units: int, port: frozenset):
        self.kernels, self.copies, self.host = kernels, copies, host
        self.window, self.units = window, units
        self.by_group = defaultdict(float)
        self.by_name = defaultdict(float)
        self.count = defaultdict(int)
        for name, a, b in kernels:
            g = group_of(name, port)
            self.by_group[g] += (b - a) * 1e-6
            self.count[g] += 1
            self.by_name[name] += (b - a) * 1e-6

    @classmethod
    def from_profiler(cls, prof, units: int, port: frozenset) -> "DeviceTrace":
        import torch

        cuda = torch.autograd.DeviceType.CUDA
        kernels, copies, host, window = [], [], [], None
        for e in prof.events():
            a, b = e.time_range.start, e.time_range.end
            if e.device_type == cuda:
                if getattr(e, "is_user_annotation", False) or e.name.startswith(SPAN_PREFIX):
                    continue
                if e.name.startswith(("Memcpy", "Memset")):
                    copies.append((a, b))
                else:
                    kernels.append((e.name, a, b))
            else:
                if e.name == SPAN_PREFIX + "window":
                    window = (a, b)
                host.append((e.name, a, b))
        if window is None:
            raise RuntimeError("the profiled sub-window has no window span")
        # what ran before the sub-window (the call left out) is not its
        kernels = [k for k in kernels if k[1] >= window[0]]
        copies = [c for c in copies if c[0] >= window[0]]
        return cls(kernels, copies, host, window, units, port)

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) * 1e-6

    def busy(self) -> List[Tuple[float, float]]:
        lo, hi = self.window
        spans = [(max(a, lo), min(b, hi)) for _, a, b in self.kernels] + \
                [(max(a, lo), min(b, hi)) for a, b in self.copies]
        return _union([(a, b) for a, b in spans if b > a])

    @property
    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy()) * 1e-6

    def group_ms(self, group: str) -> Optional[float]:
        """Device milliseconds a unit in one group's kernels; None where the
        group ran nothing."""
        if not self.count.get(group):
            return None
        return 1e3 * self.by_group[group] / self.units

    def launches(self) -> Optional[float]:
        n = sum(self.count.values())
        return n / self.units if n else None

    def idle_gaps(self, top: int = 10) -> List[List]:
        """The longest stretches of the sub-window with nothing on the
        device, each named by what the host was doing in its middle: the
        innermost harness span and the innermost host operation."""
        lo, hi = self.window
        edges = [lo] + [x for ab in self.busy() for x in ab] + [hi]
        gaps = sorted(((edges[i + 1] - edges[i], edges[i]) for i in range(0, len(edges), 2)
                       if edges[i + 1] > edges[i]), reverse=True)[:top]
        host = sorted(self.host, key=lambda e: e[1])
        starts = [e[1] for e in host]
        out = []
        for length, start in gaps:
            mid = start + length / 2
            live = [e for e in host[:bisect.bisect_right(starts, mid)] if e[2] > mid]
            span = max((e for e in live if e[0].startswith(SPAN_PREFIX)
                        and e[0] != SPAN_PREFIX + "window"), key=lambda e: e[1], default=None)
            op = max((e for e in live if not e[0].startswith(SPAN_PREFIX)),
                     key=lambda e: e[1], default=None)
            name = " > ".join(e[0][:60] for e in (span, op) if e is not None) or "host idle"
            out.append([name, length * 1e-6])
        return out

    def breakdown(self) -> Dict[str, List[List]]:
        ops = sorted(self.by_name.items(), key=lambda kv: -kv[1])[:10]
        return {"device_ops": [[n[:120], s] for n, s in ops], "idle_gaps": self.idle_gaps()}
