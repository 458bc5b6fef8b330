"""NLSPN model in PyTorch (NCHW), inference and training.

Counterpart of ``nlspn_eccv20_tpu/models/nlspn.py``: a dual-branch encoder
(RGB conv + S2D sparse-depth pyramid), ResNet-18/34 stages, a shared
transposed-conv decoder with skip concats, the initial-depth / affinity /
confidence heads, then ``prop_time`` steps of confidence-weighted spatial
propagation with a ConvGRU affinity refresh.

The loop runs hand-written CUDA kernels on the card (``ops/kernels``):
``prop_step`` 12 times and ``dep_encode_front`` and ``decode_aff_tail`` 11
times per forward at the fork default; with ``offset=True`` (the non-local
propagation) ``deform_prop`` takes ``prop_step``'s place. With a constant
affinity (``use_GRU=False``), ``prop_impl='pallas'``, no offsets and no
per-step outputs asked for, the whole loop is one ``prop_loop`` launch, as
the JAX package routes its whole-loop kernel (``_use_loop_kernel``). The
model calls them through this module's names, with the JAX package's
layouts at their boundary (planar planes, affinities and offsets, NHWC
features). Everything else is stock PyTorch.

Parameter names are the reference NLSPN ``state_dict`` names
(``conv1_rgb.0.*``, ``S2D.pool_convs.0.0.*``, ``conv2..conv4``,
``{id,off_aff,cf}_dec{1,0}.*``, ``encode_dep.{i}.0.*``, ``GRU.convz.*``,
``aff_scale_const`` ...).

With ``offset=True`` the ``off_aff`` head emits 3 N channels (N = K2 - 1):
N (dy, dx) offset pairs, then N raw affinities. The offsets get a zero pair
for the reference pixel and stay fixed for all steps (the ConvGRU refreshes
only the affinities). In train mode they are clamped to
[-offset_window, offset_window] (as ``jnp.clip``, gradient included) and
the step's backward follows the JAX windowed form's tie rules; with
``offset_window=0`` training gathers exactly at the unclamped offsets and
differentiates the exact gather, as the JAX package does there; in eval
mode the step is the exact gather for any offsets, as the JAX package's
runtime switch between its windowed and exact forms computes.

Training runs the same forward in train mode (BatchNorm on batch statistics)
and differentiates through the kernels' autograd Functions, whose backward
kernels run 12 and 11 times per step (``prop_loop``'s once, on the
whole-loop route). Gradients follow the JAX package's
conventions: ``torch.maximum`` against zero where it writes ``jnp.maximum``
(half the gradient at an exact tie), ``F.relu`` where it writes ``nn.relu``
(none), and ``aff_scale_const`` trains only under TGASS.

With ``precision='bf16'`` the network computes in bf16 where the JAX package
does, and the propagation stays f32: the parameters stay f32 and are cast
at use; rgb and the sparse depth enter as bf16 (S2D pools in f32 on the
rounded depth); the heads' stage-2 output goes to f32 before its ReLU and
sigmoid; the GRU's state, ``encode_aff``'s input and ``encode_dep``'s plane
(``pred / max_depth``) are bf16, so ``dep_encode_front`` and
``decode_aff_tail`` run their bf16 kernels; ``decode_aff_tail`` returns
f32, and ``dep_p``, the affinities, the confidence and every step stay f32,
as do ``pred`` and ``pred_init``. It trains too, as the JAX package trains
in bf16: train-mode BatchNorm reduces its statistics in f32, the loss is
f32, and under autograd the two bf16 kernels run K2-bf16 / K3-bf16 forward
and K4-bf16 / K5-bf16 backward; every parameter's gradient arrives f32.
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F
from torch import nn

from nlspn_eccv20_tpu_torch.config import Config
from nlspn_eccv20_tpu_torch.models.common import (
    Conv,
    ConvBNReLU,
    ConvTBNReLU,
    concat_trim,
)
from nlspn_eccv20_tpu_torch.models.resnet import make_encoder_stages
from nlspn_eccv20_tpu_torch.ops.affinity import (
    insert_center_offset,
    normalize_affinity,
)
from nlspn_eccv20_tpu_torch.ops.kernels.dec_aff_tail import decode_aff_tail
from nlspn_eccv20_tpu_torch.ops.kernels.deform_prop import deform_prop
from nlspn_eccv20_tpu_torch.ops.kernels.dep_encode_front import dep_encode_front
from nlspn_eccv20_tpu_torch.ops.kernels.prop_loop import prop_loop
from nlspn_eccv20_tpu_torch.ops.kernels.prop_step import prop_step
from nlspn_eccv20_tpu_torch.ops.planar import planar_channel_mlp
from nlspn_eccv20_tpu_torch.ops.propagate import clamp_offsets


def uses_loop_kernel(cfg: Config, need_inter: bool) -> bool:
    """The whole loop as one ``prop_loop``: the JAX package's
    ``_use_loop_kernel`` condition. Its VMEM check has no counterpart: the
    CUDA kernel takes any shape."""
    return (not cfg.use_GRU and not cfg.offset and not need_inter
            and cfg.prop_time >= 1 and cfg.prop_impl == "pallas")


def _mp3(x: torch.Tensor) -> torch.Tensor:
    """3x3 max pool, stride 1; its implicit -inf padding is max's identity."""
    return F.max_pool2d(x, 3, 1, 1)


class S2D(nn.Module):
    """Sparse-to-dense depth encoder (reference nlspnmodel.py:406-462).

    Min-pool pyramid (k = 3, 5, 7, 9; zeros flagged with a -999 sentinel so
    they never win the min) and max-pool pyramid (k = 11, 13), both as
    cascades of 3x3 pools (a k+2 pool is exactly a 3x3 pool of the k pool),
    two 1x1 convs, concat with the raw depth, 3x3 conv to 32 channels. The
    pooling stays f32 because of the sentinel (999 is not a bf16 value); the
    rest runs in ``dep``'s dtype.
    """

    def __init__(self):
        super().__init__()
        self.pool_convs = nn.ModuleList([nn.Sequential(Conv(6, 8, 1)),
                                         nn.Sequential(Conv(8, 16, 1))])
        self.conv = ConvBNReLU(17, 32, 3, 1, bn=False)

    def forward(self, dep: torch.Tensor) -> torch.Tensor:
        dt = dep.dtype
        d = dep.float()                              # (B, 1, H, W)
        pools = []
        m = torch.where(d == 0.0, -999.0, -d)
        for _ in (3, 5, 7, 9):                       # min pyramid: max of -d
            m = _mp3(m)
            z = -m
            pools.append(torch.where(z == 999.0, 0.0, z))
        m = d
        for s in range(3, 14, 2):                    # max pyramid: keep 11, 13
            m = _mp3(m)
            if s in (11, 13):
                pools.append(m)
        c0, c1 = self.pool_convs[0][0], self.pool_convs[1][0]
        f16 = planar_channel_mlp(torch.cat(pools, dim=1).to(dt),
                                 c0.weight[:, :, 0, 0].t(), c0.bias,
                                 c1.weight[:, :, 0, 0].t(), c1.bias)
        return self.conv(torch.cat([f16, d.to(dt)], dim=1))


class ConvGRU(nn.Module):
    """3x3 conv GRU over the affinity hidden state (reference :386-403).

    The z and r gates read the same concat(h, x); their convs run as one
    conv over the concatenated weights (same math, one read of hx).
    """

    def __init__(self, hidden_dim: int, input_dim: int):
        super().__init__()
        self.hidden_dim = hidden_dim
        self.convz = Conv(hidden_dim + input_dim, hidden_dim, 3)
        self.convr = Conv(hidden_dim + input_dim, hidden_dim, 3)
        self.convq = Conv(hidden_dim + input_dim, hidden_dim, 3)

    def forward(self, h: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        hd, dt = self.hidden_dim, h.dtype
        zr = F.conv2d(torch.cat([h, x], dim=1),
                      torch.cat([self.convz.weight, self.convr.weight]).to(dt),
                      torch.cat([self.convz.bias, self.convr.bias]).to(dt), padding=1)
        z = torch.sigmoid(zr[:, :hd])
        r = torch.sigmoid(zr[:, hd:])
        q = torch.tanh(self.convq(torch.cat([r * h, x], dim=1)))
        return (1.0 - z) * h + z * q


class EncodeDep(nn.Sequential):
    """Loop depth plane -> GRU input feature at 1/8 (reference :134-138).

    conv0 (1->16) and conv1 (16->2c) run as the ``dep_encode_front`` kernel
    (its bf16 form on a bf16 plane); conv2 (2c->c) is a stock conv on its
    NHWC output.
    """

    def __init__(self, cfg: Config):
        c = cfg.GRU_input_dim
        super().__init__(ConvBNReLU(1, 16, 3, 2, bn=False),
                         ConvBNReLU(16, 2 * c, 3, 2, bn=False),
                         ConvBNReLU(2 * c, c, 3, 2, bn=False))

    def forward(self, plane: torch.Tensor) -> torch.Tensor:
        y = dep_encode_front(plane, self[0][0].weight, self[0][0].bias,
                             self[1][0].weight, self[1][0].bias)
        return self[2](y.permute(0, 3, 1, 2))


class DecodeAff(nn.Sequential):
    """GRU hidden state -> raw planar neighbor affinities (reference :140-144).

    deconv0 is a stock transposed conv; deconv1 + ReLU + deconv2 run as the
    ``decode_aff_tail`` kernel (its bf16 form on a bf16 state), whose output
    is planar (B, K2 - 1, H, W) f32.
    """

    def __init__(self, cfg: Config):
        c = cfg.GRU_hidden_dim
        super().__init__(
            ConvTBNReLU(c, 2 * c, bn=False),
            ConvTBNReLU(2 * c, 16, bn=False),
            ConvTBNReLU(16, cfg.num_neighbors, bn=False, relu=False,
                        zero_init=cfg.zero_init_aff))

    def forward(self, h: torch.Tensor) -> torch.Tensor:
        x = self[0](h).permute(0, 2, 3, 1).contiguous()
        return decode_aff_tail(x, self[1][0].weight, self[1][0].bias,
                               self[2][0].weight, self[2][0].bias)


class EncodeAff(nn.Sequential):
    """Initial affinity -> GRU hidden state at 1/8, tanh (reference :127-132)."""

    def __init__(self, cfg: Config):
        c = cfg.GRU_hidden_dim
        super().__init__(
            ConvBNReLU(cfg.num_neighbors + 1, 16, 3, 2, bn=False),
            ConvBNReLU(16, 2 * c, 3, 2, bn=False),
            ConvBNReLU(2 * c, c, 3, 2, bn=False, relu=False))

    def forward(self, aff: torch.Tensor) -> torch.Tensor:
        return torch.tanh(super().forward(aff))


class NLSPNModel(nn.Module):
    """Full NLSPN network. sample: {'rgb': (B, 3, H, W), 'dep': (B, 1, H, W)}."""

    HEAD_WIDTH = 64  # per-head stage-1 channels (reference :67, 72, 78)

    def __init__(self, cfg: Config):
        super().__init__()
        self.cfg = cfg
        # the compute dtype (JAX NLSPNModel.dtype); parameters stay f32
        self.compute_dtype = torch.bfloat16 if cfg.precision == "bf16" else torch.float32
        nn_ = cfg.num_neighbors
        width = self.HEAD_WIDTH

        self.conv1_rgb = ConvBNReLU(3, 32, 3, 1, bn=False)
        if cfg.use_S2D:
            self.S2D = S2D()
        else:
            self.conv1_dep = ConvBNReLU(1, 32, 3, 1, bn=False)
        self.conv2, self.conv3, self.conv4 = make_encoder_stages(cfg.network)
        self.conv5 = ConvBNReLU(256, 256, 3, 2)
        self.dec4 = ConvTBNReLU(256, 128)
        self.dec3 = ConvTBNReLU(128 + 256, 64)
        self.dec2 = ConvTBNReLU(64 + 128, 64)

        # Heads: stage 1 on concat(fd2, fe2), stage 2 on concat(stage 1, fe1).
        self.head_specs = [("id", 1), ("off_aff", 3 * nn_ if cfg.offset else nn_)]
        if cfg.conf_prop:
            self.head_specs.append(("cf", 1))
        for name, n_out in self.head_specs:
            self.add_module(f"{name}_dec1", ConvBNReLU(64 + 64, width, 3, 1))
            self.add_module(f"{name}_dec0", ConvBNReLU(
                width + 64, n_out, 3, 1, bn=False, relu=False,
                zero_init=cfg.zero_init_aff and name == "off_aff"))

        gamma_init = {"TC": float(nn_),
                      "TGASS": cfg.affinity_gamma * nn_}.get(cfg.affinity, 1.0)
        self.aff_scale_const = nn.Parameter(torch.full((1,), gamma_init))

        if cfg.use_GRU:
            self.encode_aff = EncodeAff(cfg)
            self.encode_dep = EncodeDep(cfg)
            self.decode_aff = DecodeAff(cfg)
            self.GRU = ConvGRU(cfg.GRU_hidden_dim, cfg.GRU_input_dim)

    def run_heads(self, fd2fe2: torch.Tensor, fe1: torch.Tensor):
        """The JAX package's ``Heads``: planar (pred_init, raw aff, conf),
        f32 from stage 2 on."""
        out = {name: getattr(self, f"{name}_dec0")(torch.cat(
                   [getattr(self, f"{name}_dec1")(fd2fe2), fe1], dim=1)).float()
               for name, _ in self.head_specs}
        pred_init = F.relu(out["id"][:, 0])
        conf = torch.sigmoid(out["cf"][:, 0]) if "cf" in out else None
        return pred_init, out["off_aff"], conf

    def forward(self, sample: Dict[str, torch.Tensor],
                need_inter: bool = True) -> Dict[str, object]:
        cfg, dt = self.cfg, self.compute_dtype
        rgb, dep = sample["rgb"].to(dt), sample["dep"].float()

        # ---- Encoder (reference :276-288) ----
        fe1_dep = self.S2D(dep.to(dt)) if cfg.use_S2D else self.conv1_dep(dep.to(dt))
        fe1 = torch.cat([self.conv1_rgb(rgb), fe1_dep], dim=1)    # 64 @ 1/1
        fe2 = self.conv2(fe1)                                      # 64 @ 1/1
        fe3 = self.conv3(fe2)                                      # 128 @ 1/2
        fe4 = self.conv4(fe3)                                      # 256 @ 1/4
        fe5 = self.conv5(fe4)                                      # 256 @ 1/8

        # ---- Shared decoder (reference :291-293) ----
        fd4 = self.dec4(fe5)
        fd3 = self.dec3(concat_trim(fd4, fe4))
        fd2 = self.dec2(concat_trim(fd3, fe3))
        pred_init, aff_raw, conf = self.run_heads(concat_trim(fd2, fe2), fe1)
        off = step_off = radius = None
        if cfg.offset:
            off = insert_center_offset(aff_raw[:, :2 * cfg.num_neighbors])
            aff_raw = aff_raw[:, 2 * cfg.num_neighbors:]
            step_off = off
            if self.training and cfg.offset_window:
                # JAX: fallback=False clamps, then the window; window 0
                # (radius None) is the exact gather, unclamped
                radius = cfg.offset_window
                step_off = clamp_offsets(off, radius)

        # ---- Affinity normalization (reference :179-201, 323-325) ----
        gamma = self.aff_scale_const
        if cfg.affinity != "TGASS":
            gamma = gamma.detach()  # frozen for AS/ASS/TC (reference :95-102)
        aff = normalize_affinity(aff_raw, gamma, cfg.affinity).contiguous()
        dep_p = dep[:, 0].contiguous()
        h, w = dep_p.shape[1:]

        # ---- Input preservation and the k == 1 blend (reference :328-348) ----
        pred = pred_init
        if cfg.preserve_input:
            mask_fix = (dep_p > 0.0).float()
            if conf is not None:
                conf = (1.0 - mask_fix) * conf + mask_fix
            pred = (1.0 - mask_fix) * pred + mask_fix * dep_p
        if cfg.always_clip:
            pred = torch.maximum(pred, torch.zeros_like(pred))
        if conf is not None:
            conf = conf.contiguous()
        pred = pred.contiguous()

        def step(p: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
            kw = dict(kernel=cfg.prop_kernel, preserve=cfg.preserve_input,
                      clip=cfg.always_clip)
            d = dep_p if cfg.preserve_input else None
            if off is not None:
                return deform_prop(p, step_off, a, conf, d, radius=radius, **kw)
            return prop_step(p, a, conf, d, **kw)

        # ---- Propagation loop (reference :340-373) ----
        # every step's plane, whatever need_inter says (as JAX): each is the
        # next step's input anyway. need_inter only rules out the loop kernel.
        inter = []
        if uses_loop_kernel(cfg, need_inter):
            # all steps in one launch; the k == 1 blend above already
            # happened, so no pre-blend (as JAX); pred_inter stays empty
            pred = prop_loop(pred, aff, conf,
                             dep_p if cfg.preserve_input else None,
                             steps=cfg.prop_time, kernel=cfg.prop_kernel,
                             preserve=cfg.preserve_input,
                             clip=cfg.always_clip, pre_blend=False)
        else:
            if cfg.use_GRU:
                aff_feat = self.encode_aff(aff.to(dt))
            for _ in range(cfg.prop_time - 1):
                pred = step(pred, aff)
                inter.append(pred)
                if cfg.use_GRU:
                    dep_feat = self.encode_dep((pred / cfg.max_depth).to(dt))
                    aff_feat = self.GRU(aff_feat, dep_feat)
                    raw = self.decode_aff(aff_feat)[:, :, :h, :w]   # f32
                    aff = normalize_affinity(raw, gamma, cfg.affinity).contiguous()
            # Final iteration: propagate only, no GRU refresh (reference k == K).
            pred = step(pred, aff)
            inter.append(pred)
        if not cfg.always_clip:
            pred = torch.maximum(pred, torch.zeros_like(pred))

        return {
            "pred": pred[:, None],
            "pred_init": pred_init[:, None],
            "pred_inter": [p[:, None] for p in inter],
            "offset": off,
            "aff": aff,
            "gamma": gamma.detach(),
            "confidence": conf[:, None] if conf is not None else None,
        }
