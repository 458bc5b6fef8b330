"""Device selection for the port's entry points.

The port runs on a CUDA card. The CPU is used only when the caller asks for
it (``device="cpu"``), and then every kernel wrapper runs its plain PyTorch
version. There is no silent fallback from a missing card to the CPU.
"""

from __future__ import annotations

from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """``None`` means the first CUDA card, and raises when there is none."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "plain PyTorch versions on the CPU")
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(device)


def cudnn_benchmark_mode():
    """cuDNN times its algorithms once per conv shape, for the calls inside
    this context only; every other cuDNN flag keeps its current value. Its
    heuristics pick FFT convs at b=4 that double the forward's time
    (PERF.md)."""
    b = torch.backends.cudnn
    return b.flags(enabled=b.enabled, benchmark=True,
                   deterministic=b.deterministic, allow_tf32=b.allow_tf32)
