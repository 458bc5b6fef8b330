"""Seeded random weights for both sides of the comparison.

Made on the device in two draws (one normal, one uniform) from a
``torch.Generator`` seeded with the run's seed, then cut into the
parameters of ``model.param_specs``: conv weights N(0, 1/fan_in), biases
N(0, 0.1^2), BatchNorm scale and running variance U(0.5, 1.5), its shift
and running mean N(0, 0.1^2), gamma at its published start
(``affinity_gamma`` x neighbours). The heads are set apart so that the
propagation does real work and, as in a trained NLSPN, does not amplify:

- the offset channels of ``off_aff_dec0`` are scaled so that offsets
  reach a few pixels (a zero head would leave the non-local steps reading
  the plain grid);
- every affinity channel (those of ``off_aff_dec0`` and, with the ConvGRU,
  of ``decode_aff.2.0``) has small weights and a bias of U(1, 2), so
  that the raw affinities are of one sign: each step is then a weighted
  mean of its neighbours, and depth stays inside the range of the initial
  depth and the observed one (random weights of both signs make the
  18-step propagation grow by orders of magnitude);
- ``id_dec0`` has small weights and a bias of U(1, 3), so that the
  initial depth is mostly above 0 and inside every scene's range.
"""

from __future__ import annotations

from typing import Dict

import torch

from gpubench.reference.model import neighbours, param_specs

OFFSET_SCALE = 2.0
RESIDUAL_SCALE = 0.3
HEAD_WEIGHT_SCALE = 0.05


def make_weights(c, seed: int, device) -> Dict[str, torch.Tensor]:
    specs = param_specs(c)
    normal_kinds = ("conv", "bias", "bn_bias", "bn_mean")
    numel = {name: torch.Size(shape).numel() for name, shape, _, _ in specs}
    n_normal = sum(numel[n] for n, _, k, _ in specs if k in normal_kinds)
    n_uniform = sum(numel[n] for n, _, k, _ in specs if k in ("bn_weight", "bn_var"))
    gen = torch.Generator(device=device).manual_seed(int(seed))
    normal = torch.randn(n_normal, generator=gen, device=device)
    n_aff = neighbours(c) * (2 if c.use_GRU else 1)
    uniform = torch.rand(n_uniform + 2 + n_aff, generator=gen, device=device)
    out: Dict[str, torch.Tensor] = {}
    i = j = 0
    for name, shape, kind, fan_in in specs:
        n = numel[name]
        if kind in normal_kinds:
            std = fan_in ** -0.5 if kind == "conv" else 0.1
            t = normal[i:i + n].view(shape) * std
            i += n
        elif kind in ("bn_weight", "bn_var"):
            t = 0.5 + uniform[j:j + n].view(shape)
            j += n
        elif kind == "gamma":
            t = torch.full(shape, c.affinity_gamma * neighbours(c), device=device)
        else:
            t = torch.zeros(shape, dtype=torch.int64, device=device)
        out[name] = t
    n = neighbours(c)
    n_off = 2 * n if c.offset else 0
    out["off_aff_dec0.0.weight"][:n_off] *= OFFSET_SCALE
    out["off_aff_dec0.0.bias"][:n_off] *= OFFSET_SCALE
    aff_bias = 1.0 + uniform[j + 2:j + 2 + n_aff]
    out["off_aff_dec0.0.weight"][n_off:] *= HEAD_WEIGHT_SCALE
    out["off_aff_dec0.0.bias"][n_off:] = aff_bias[:n]
    if c.use_GRU:
        out["decode_aff.2.0.weight"] *= HEAD_WEIGHT_SCALE
        out["decode_aff.2.0.bias"] = aff_bias[n:]
    out["id_dec0.0.weight"] *= HEAD_WEIGHT_SCALE
    out["id_dec0.0.bias"] = 1.0 + 2.0 * uniform[j:j + 1]
    if c.conf_prop:
        out["cf_dec0.0.bias"] = 2.0 + 2.0 * uniform[j + 1:j + 2]
    for name, shape, kind, _ in specs:
        if kind == "bn_weight" and name.endswith(("bn2.weight", "downsample.1.weight")):
            out[name] *= RESIDUAL_SCALE
    return out
