"""Affinity normalization and center insertion, planar (B, N, H, W).

Counterpart of the planar functions of ``nlspn_eccv20_tpu/ops/affinity.py``
(reference ``_affinity_normalization`` and ``_aff_insert``): optional
tanh/gamma scaling (TC / TGASS), abs-sum + 1e-4, the sum clamped to at least
1 (ASS / TGASS), division (AS / ASS / TGASS; TC is scaled but not divided),
then the reference pixel's affinity ``1 - sum(aff)`` inserted at channel
``N // 2``.
"""

from __future__ import annotations

import torch

VALID_AFFINITY_MODES = ("AS", "ASS", "TC", "TGASS")


def insert_center_affinity_planar(aff: torch.Tensor) -> torch.Tensor:
    """(B, N, H, W) -> (B, N + 1, H, W), center = 1 - sum at index N // 2."""
    idx_ref = aff.shape[1] // 2
    center = 1.0 - torch.sum(aff, dim=1, keepdim=True)
    return torch.cat([aff[:, :idx_ref], center, aff[:, idx_ref:]], dim=1)


def normalize_affinity_planar(aff: torch.Tensor, gamma: torch.Tensor,
                              mode: str = "TGASS") -> torch.Tensor:
    """Normalize raw (B, N, H, W) neighbor affinities and insert the center:
    (B, N + 1, H, W). gamma has shape (1,)."""
    if mode not in VALID_AFFINITY_MODES:
        raise NotImplementedError(f"affinity mode {mode}")

    if mode == "TC":
        aff = torch.tanh(aff) / gamma
    elif mode == "TGASS":
        aff = torch.tanh(aff) / (gamma + 1e-8)

    aff_abs_sum = torch.sum(torch.abs(aff), dim=1, keepdim=True) + 1e-4
    if mode in ("ASS", "TGASS"):
        # jnp.maximum's convention: half the gradient to each side at a tie
        aff_abs_sum = torch.maximum(aff_abs_sum, torch.ones_like(aff_abs_sum))
    if mode in ("AS", "ASS", "TGASS"):
        aff = aff / aff_abs_sum

    return insert_center_affinity_planar(aff)
