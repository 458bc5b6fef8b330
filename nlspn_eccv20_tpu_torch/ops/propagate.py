"""Fixed-local spatial propagation, plain PyTorch (the oracle of the
``prop_step`` kernel).

Counterpart of ``propagate_local_planar`` in
``nlspn_eccv20_tpu/ops/propagate.py`` (reference ``_propagate_once``,
no-offset branch): replicate-pad the depth plane and sum the k*k shifted
neighbors, each weighted by its affinity plane.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def neighbor_shifts(kernel: int):
    """Row-major (dy, dx) shifts of a kernel x kernel stencil, center included."""
    r = kernel // 2
    return [(dy, dx) for dy in range(-r, r + 1) for dx in range(-r, r + 1)]


def propagate_local_planar(p: torch.Tensor, aff: torch.Tensor,
                           kernel: int = 3) -> torch.Tensor:
    """p: (B, H, W) plane (already confidence-weighted by the caller);
    aff: (B, K2, H, W), K2 = kernel**2, row-major neighbor order with the
    center at K2 // 2. Returns (B, H, W)."""
    if kernel % 2 != 1:
        raise ValueError(f"kernel must be odd, got {kernel}")
    if aff.shape[1] != kernel * kernel:
        raise ValueError(f"aff has {aff.shape[1]} channels, want {kernel * kernel}")
    _, h, w = p.shape
    r = kernel // 2
    padded = F.pad(p[:, None], (r, r, r, r), mode="replicate")[:, 0]
    out = torch.zeros_like(p)
    for idx, (dy, dx) in enumerate(neighbor_shifts(kernel)):
        window = padded[:, dy + r:dy + r + h, dx + r:dx + r + w]
        out = out + window * aff[:, idx]
    return out
