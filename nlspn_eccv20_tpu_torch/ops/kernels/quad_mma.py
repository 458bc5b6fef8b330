"""``csrc/quad_mma.cuh`` mirrored in PyTorch: the quad scheme of a k3/s2/p1
transposed convolution to 16 channels as the bf16 tensor cores compute it,
for K2-bf16's deconv1 and K5-bf16's dP0 pass.

``pack`` lays a weight out as ``quad::prep_kernel`` does (bf16, each k-step
of 16 channels as the B operand of 144 columns in K-major core matrices);
``b_operand`` reads a product's B back from that layout as the ``wgmma``
descriptor reads it; ``mma_kstep`` adds a k-step's four shifted products
into the 64 accumulator columns, as ``quad::mma_kstep`` issues them. The
CPU tests build the kernels' arithmetic from these and hold it to the
plain versions; nothing here runs on the card.
"""

from __future__ import annotations

from typing import Sequence

import torch

M = 16                 # output channels
KSTEP = 16             # channels a k-step
NCOL = 9 * M           # B columns a k-step
KSTEP_BF16 = NCOL * KSTEP
QTAPS = (5, 8, 7, 4, 3, 6, 2, 1, 0)          # tap of each 16-column block of B
PHASES = ((0, 1), (1, 1), (1, 0), (0, 0))    # (dy, dx) of each accumulator block
SHIFTS = ((0, 0), (0, 1), (1, 0), (1, 1))    # (sy, sx) of a[0..3]
# each shift's product: (first B column, N, first accumulator column)
PRODUCTS = ((0, 64, 0), (64, 32, 0), (96, 32, 16), (128, 16, 16))


def kmajor_index(n: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """bf16 offset of column n, channel k in K-major core matrices without
    swizzle (8 columns x 8 channels a core, 128 bytes apart along K, 256
    along N)."""
    return (n // 8) * 128 + (k // 8) * 64 + (n % 8) * 8 + k % 8


def pack(w: torch.Tensor, ksteps: int) -> torch.Tensor:
    """(ksteps, KSTEP_BF16) bf16: w (C, 16, 3, 3) as ``quad::prep_kernel``
    writes it, zero past C."""
    c = w.shape[0]
    wpad = torch.zeros(ksteps * KSTEP, M, 9)
    wpad[:c] = w.detach().float().cpu().reshape(c, M, 9)
    n, k = torch.arange(NCOL), torch.arange(KSTEP)
    taps = torch.tensor(QTAPS)[n // M]
    # vals[ks, n, k] = w[16 ks + k][n % 16][tap(n)]
    vals = wpad.view(ksteps, KSTEP, M, 9)[:, :, n % M, taps].permute(0, 2, 1)
    out = torch.zeros(ksteps, KSTEP_BF16, dtype=torch.bfloat16)
    out[:, kmajor_index(n[:, None], k[None, :]).reshape(-1)] = (
        vals.reshape(ksteps, -1).to(torch.bfloat16))
    return out


def b_operand(wk: torch.Tensor, n0: int, n: int) -> torch.Tensor:
    """(16, n) f32: the B operand whose descriptor starts at column n0 of a
    k-step's packed ``wk``, read as ``wgmma`` reads it."""
    cols, k = torch.arange(n0, n0 + n), torch.arange(KSTEP)
    return wk[kmajor_index(cols[None, :], k[:, None])].float()


def mma_kstep(acc: torch.Tensor, a: Sequence[torch.Tensor], wk: torch.Tensor) -> None:
    """acc (R, 64) f32 += the four shifted products of one k-step: a[s]
    (R, 16) is shift s's A (bf16 values), wk the k-step's packed B."""
    for a_s, (b0, n, c0) in zip(a, PRODUCTS):
        acc[:, c0:c0 + n] += a_s @ b_operand(wk, b0, n)
