"""Weights for the port: the bridge from the JAX package's variables, and
seeded random weights.

``from_jax_variables`` is the inverse of the JAX package's
``utils/torch_import.import_nlspn_state_dict``: it takes the JAX model's
``{params, batch_stats}`` tree (nested dicts of numpy arrays) and returns
the reference-named ``state_dict`` that ``NLSPNModel.load_state_dict``
takes. Layout conversions:

* Conv kernels HWIO -> OIHW.
* ConvTranspose kernels are stored by the JAX package pre-flipped
  spatially (the lhs-dilated-conv convention): un-flip, then HWIO -> IOHW
  (torch's (in, out, kH, kW)).
* The fused heads keep one stage-1 conv and BatchNorm over the concatenated
  channels of all heads (id, off_aff[, cf]); they are split back per head.
* BatchNorm scale/bias come from ``params``, running mean/var from
  ``batch_stats``.

``from_jax_op_variables`` does the same for the op library's six modules
(``ops/modules.py``): conv kernels HWIO -> OIHW, Dense kernels (in, out) ->
Linear (out, in).
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch
from torch import nn

from nlspn_eccv20_tpu_torch.models.resnet import STAGE_BLOCKS
from nlspn_eccv20_tpu_torch.ops import modules

Tree = Dict[str, Any]


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, np.float32, order="C"))


def _conv_w(k) -> torch.Tensor:
    return _t(np.transpose(np.asarray(k), (3, 2, 0, 1)))        # HWIO -> OIHW


def _convt_w(k) -> torch.Tensor:
    return _t(np.transpose(np.flip(np.asarray(k), (0, 1)), (2, 3, 0, 1)))


def from_jax_variables(variables: Tree, cfg) -> Dict[str, torch.Tensor]:
    """JAX ``{params, batch_stats}`` -> the port's ``state_dict`` (CPU tensors)."""
    p, s = variables["params"], variables.get("batch_stats", {})
    sd: Dict[str, torch.Tensor] = {}

    def bn(prefix: str, pnode: Tree, snode: Tree) -> None:
        sd[prefix + "weight"] = _t(pnode["scale"])
        sd[prefix + "bias"] = _t(pnode["bias"])
        sd[prefix + "running_mean"] = _t(snode["mean"])
        sd[prefix + "running_var"] = _t(snode["var"])
        sd[prefix + "num_batches_tracked"] = torch.tensor(0)

    def conv_bnfree(prefix: str, node: Tree, transposed: bool = False) -> None:
        sd[prefix + "0.weight"] = (_convt_w if transposed else _conv_w)(node["kernel"])
        sd[prefix + "0.bias"] = _t(node["bias"])

    def conv_bn(prefix: str, pnode: Tree, snode: Tree,
                transposed: bool = False) -> None:
        k = pnode["conv"]["kernel"]
        sd[prefix + "0.weight"] = _convt_w(k) if transposed else _conv_w(k)
        bn(prefix + "1.", pnode["bn"]["BatchNorm_0"], snode["bn"]["BatchNorm_0"])

    conv_bnfree("conv1_rgb.", p["conv1_rgb"]["conv"])
    if cfg.use_S2D:
        s2d = p["S2D"]
        for i in range(2):
            sd[f"S2D.pool_convs.{i}.0.weight"] = _conv_w(s2d[f"pool_conv{i}_kernel"])
            sd[f"S2D.pool_convs.{i}.0.bias"] = _t(s2d[f"pool_conv{i}_bias"])
        conv_bnfree("S2D.conv.", s2d["conv"]["conv"])
    else:
        conv_bnfree("conv1_dep.", p["conv1_dep"]["conv"])

    for stage, nb in zip(("conv2", "conv3", "conv4"), STAGE_BLOCKS[cfg.network]):
        for b in range(nb):
            blk, bst = p[stage][f"block{b}"], s[stage][f"block{b}"]
            pre = f"{stage}.{b}."
            for i in (1, 2):
                sd[f"{pre}conv{i}.weight"] = _conv_w(blk[f"conv{i}"]["kernel"])
                bn(f"{pre}bn{i}.", blk[f"bn{i}"]["BatchNorm_0"],
                   bst[f"bn{i}"]["BatchNorm_0"])
            if "downsample_conv" in blk:
                sd[pre + "downsample.0.weight"] = _conv_w(blk["downsample_conv"]["kernel"])
                bn(pre + "downsample.1.", blk["downsample_bn"]["BatchNorm_0"],
                   bst["downsample_bn"]["BatchNorm_0"])

    conv_bn("conv5.", p["conv5"], s["conv5"])
    for dec in ("dec4", "dec3", "dec2"):
        conv_bn(dec + ".", p[dec], s[dec], transposed=True)

    heads = ["id", "off_aff"] + (["cf"] if cfg.conf_prop else [])
    hp, hs = p["heads"], s["heads"]
    k1 = np.asarray(hp["dec1_conv"]["kernel"])
    width = k1.shape[-1] // len(heads)
    bnp, bns = hp["dec1_bn"]["BatchNorm_0"], hs["dec1_bn"]["BatchNorm_0"]
    for i, h in enumerate(heads):
        cut = slice(i * width, (i + 1) * width)
        sd[f"{h}_dec1.0.weight"] = _conv_w(k1[..., cut])
        bn(f"{h}_dec1.1.",
           {k: np.asarray(v)[cut] for k, v in bnp.items()},
           {k: np.asarray(v)[cut] for k, v in bns.items()})
        sd[f"{h}_dec0.0.weight"] = _conv_w(hp[f"{h}_dec0_kernel"])
        sd[f"{h}_dec0.0.bias"] = _t(hp[f"{h}_dec0_bias"])

    sd["aff_scale_const"] = _t(p["aff_scale_const"]).reshape(1)

    if cfg.use_GRU:
        for i in range(3):
            conv_bnfree(f"encode_aff.{i}.", p["encode_aff"][f"conv{i}"]["conv"])
        ps = p["prop_step"]
        for i in range(3):
            conv_bnfree(f"encode_dep.{i}.", ps["encode_dep"][f"conv{i}"]["conv"])
            conv_bnfree(f"decode_aff.{i}.", ps["decode_aff"][f"deconv{i}"]["conv"],
                        transposed=True)
        gru = ps["GRU"]
        for gate in ("convz", "convr"):
            sd[f"GRU.{gate}.weight"] = _conv_w(gru[f"{gate}_kernel"])
            sd[f"GRU.{gate}.bias"] = _t(gru[f"{gate}_bias"])
        sd["GRU.convq.weight"] = _conv_w(gru["convq"]["kernel"])
        sd["GRU.convq.bias"] = _t(gru["convq"]["bias"])
    return sd


def from_jax_op_variables(variables: Tree, module: nn.Module) -> Dict[str, torch.Tensor]:
    """The ``{params}`` of one of the JAX package's op-library modules ->
    the ``state_dict`` of ``module``, the port's module of the same class.
    ``DeformRoIPoolingPack``'s ``fc0`` reads the pooled map flattened as
    (output_dim, ps, ps) in the port and as (ps, ps, output_dim) in the JAX
    package: its input rows are permuted, not copied."""
    p = variables.get("params", {})
    sd: Dict[str, torch.Tensor] = {}
    if isinstance(module, modules.DeformConv):
        sd["weight"] = _conv_w(p["weight"])
        if "bias" in p:
            sd["bias"] = _t(p["bias"])
        for name in ("conv_offset", "conv_offset_mask"):
            if name in p:
                sd[name + ".weight"] = _conv_w(p[name]["kernel"])
                sd[name + ".bias"] = _t(p[name]["bias"])
    elif isinstance(module, modules.DeformRoIPoolingPack):
        ps, d = module.pooled_size, module.output_dim
        k0 = np.asarray(p["fc0"]["kernel"])
        k0 = k0.reshape(ps, ps, d, -1).transpose(2, 0, 1, 3).reshape(d * ps * ps, -1)
        sd["fc0.weight"] = _t(k0.T)
        sd["fc0.bias"] = _t(p["fc0"]["bias"])
        for name in ("fc1", "fc_offset"):
            sd[name + ".weight"] = _t(np.asarray(p[name]["kernel"]).T)
            sd[name + ".bias"] = _t(p[name]["bias"])
    elif not isinstance(module, modules.DeformRoIPooling):
        raise TypeError(f"not an op-library module: {type(module).__name__}")
    return sd


@torch.no_grad()
def randomize_(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """Overwrite every parameter and BatchNorm statistic of ``model`` with
    values drawn from ``generator`` (a CPU generator), scaled so that
    activations stay O(1): conv weights N(0, 1/fan_in), biases N(0, 0.1^2),
    BN scale and running variance U(0.5, 1.5), BN shift and running mean
    N(0, 0.1^2), ``aff_scale_const`` U(1, 5). No head is left zero, so every
    affinity is non-trivial."""
    def normal(t, std):
        t.copy_(torch.randn(t.shape, generator=generator) * std)

    def uniform(t, lo, hi):
        t.copy_(lo + (hi - lo) * torch.rand(t.shape, generator=generator))

    for m in model.modules():
        if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d)):
            w = m.weight
            fan_in = w[0].numel()
            if isinstance(m, nn.ConvTranspose2d):  # (in, out, k, k), stride 2
                fan_in = w.shape[0] * w.shape[2] * w.shape[3] // 4
            normal(w, fan_in ** -0.5)
            if m.bias is not None:
                normal(m.bias, 0.1)
        elif isinstance(m, nn.BatchNorm2d):
            uniform(m.weight, 0.5, 1.5)
            normal(m.bias, 0.1)
            normal(m.running_mean, 0.1)
            uniform(m.running_var, 0.5, 1.5)
    if hasattr(model, "aff_scale_const"):
        uniform(model.aff_scale_const, 1.0, 5.0)
    return model


@torch.no_grad()
def init_weights_(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """Draw ``model``'s initial weights from ``generator`` (a CPU
    generator), with the distributions its constructors use: PyTorch's
    default for a conv (weight and bias U(-1/sqrt(fan_in), 1/sqrt(fan_in))),
    kaiming normal (fan_out, ReLU) for the ResNet stages' convs, zeros where
    a conv is zero-initialised; BatchNorm reset. The weights are then a
    function of the generator's seed alone, whatever the global RNG holds."""
    def draw(t, fill):
        cpu = torch.empty(t.shape, dtype=t.dtype)
        fill(cpu)
        t.copy_(cpu)

    for m in model.modules():
        if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d)):
            params = [m.weight] + ([m.bias] if m.bias is not None else [])
            fan_in, fan_out = nn.init._calculate_fan_in_and_fan_out(m.weight)
            if getattr(m, "zero_init", False):
                for p in params:
                    p.zero_()
            elif getattr(m, "fan_out_init", False):
                std = (2.0 / fan_out) ** 0.5
                draw(m.weight, lambda t: t.normal_(0.0, std, generator=generator))
            else:
                bound = fan_in ** -0.5
                for p in params:
                    draw(p, lambda t: t.uniform_(-bound, bound, generator=generator))
        elif isinstance(m, nn.BatchNorm2d):
            m.reset_parameters()
    return model
