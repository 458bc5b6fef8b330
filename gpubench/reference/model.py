"""Plain PyTorch reference of NLSPN, the yardstick the benchmark holds the
port against.

Written from the published model (Park et al., ECCV 2020, and the
XJTUXYC fork's ConvGRU affinity refresh), in float32, with stock
``torch.nn.functional`` calls only: no kernel, no cache, no batching
trick. It imports nothing of the measured package and nothing of JAX.

The model is a function of a flat ``{name: tensor}`` dict whose names are
the reference ``state_dict``'s (``conv1_rgb.0.weight``, ``conv2.0.bn1.*``,
``off_aff_dec0.0.*``, ``GRU.convz.*`` ...), so one dict made by
``reference.weights`` loads into both sides. ``cfg`` is a namespace of
the configuration file's fields (``load_config``).

Where a value can tie (the final clip at 0, the loss's clip) the
reference breaks the tie as the published JAX/Flax training code does:
``torch.maximum`` splits the gradient, ``|x|`` passes +1 at 0. Elsewhere a
tie has probability 0 on random inputs and the plain op is used.

``tf32`` emulates the TensorFloat-32 tensor cores on any device: every
convolution's two operands are rounded to 10 mantissa bits first (the
accumulation stays float32). It is the benchmark's control, the precision
just below the configuration's float32 with TF32 off.
"""

from __future__ import annotations

import types
from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F

STAGE_BLOCKS = {"resnet18": (2, 2, 2), "resnet34": (3, 4, 6)}
HEAD_WIDTH = 64
BN_EPS = 1e-5
IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
CONFIG_FIELDS = ("network", "use_S2D", "use_GRU", "GRU_hidden_dim", "GRU_input_dim",
                 "prop_time", "prop_kernel", "affinity", "affinity_gamma",
                 "conf_prop", "preserve_input", "always_clip", "offset",
                 "offset_window", "max_depth", "loss")

# the kinds of param_specs that are trained; the rest are statistics
PARAM_KINDS = ("conv", "bias", "bn_weight", "bn_bias", "gamma")

Spec = Tuple[str, Tuple[int, ...], str, int]


def load_config(fields: Dict) -> types.SimpleNamespace:
    """The reference's view of a configuration file's ``config`` dict; every
    field it reads must be stated there."""
    missing = [k for k in CONFIG_FIELDS if k not in fields]
    if missing:
        raise KeyError(f"configuration lacks {missing}")
    if fields["affinity"] != "TGASS":
        raise NotImplementedError("the reference implements TGASS affinities")
    return types.SimpleNamespace(**{k: fields[k] for k in CONFIG_FIELDS})


def neighbours(c) -> int:
    return c.prop_kernel * c.prop_kernel - 1


def heads(c) -> List[Tuple[str, int]]:
    """(name, output channels) of the heads, in the reference's order."""
    n = neighbours(c)
    out = [("id", 1), ("off_aff", 3 * n if c.offset else n)]
    return out + ([("cf", 1)] if c.conf_prop else [])


def param_specs(c) -> List[Spec]:
    """(name, shape, kind, fan_in) of every parameter and buffer."""
    specs: List[Spec] = []

    def conv(name, cin, cout, k, bias=True):
        specs.append((f"{name}.weight", (cout, cin, k, k), "conv", cin * k * k))
        if bias:
            specs.append((f"{name}.bias", (cout,), "bias", 0))

    def convt(name, cin, cout, bias=True):
        # (in, out, 3, 3), stride 2: each output reads a quarter of the taps
        specs.append((f"{name}.weight", (cin, cout, 3, 3), "conv", cin * 9 // 4))
        if bias:
            specs.append((f"{name}.bias", (cout,), "bias", 0))

    def bn(name, ch):
        for suffix, kind in (("weight", "bn_weight"), ("bias", "bn_bias"),
                             ("running_mean", "bn_mean"), ("running_var", "bn_var")):
            specs.append((f"{name}.{suffix}", (ch,), kind, 0))
        specs.append((f"{name}.num_batches_tracked", (), "count", 0))

    conv("conv1_rgb.0", 3, 32, 3)
    if c.use_S2D:
        conv("S2D.pool_convs.0.0", 6, 8, 1)
        conv("S2D.pool_convs.1.0", 8, 16, 1)
        conv("S2D.conv.0", 17, 32, 3)
    else:
        conv("conv1_dep.0", 1, 32, 3)
    stages = zip(("conv2", "conv3", "conv4"), (64, 64, 128), (64, 128, 256),
                 STAGE_BLOCKS[c.network], (1, 2, 2))
    for stage, cin, cout, blocks, stride in stages:
        for b in range(blocks):
            ci = cin if b == 0 else cout
            pre = f"{stage}.{b}"
            conv(f"{pre}.conv1", ci, cout, 3, bias=False)
            bn(f"{pre}.bn1", cout)
            conv(f"{pre}.conv2", cout, cout, 3, bias=False)
            bn(f"{pre}.bn2", cout)
            if b == 0 and (stride != 1 or ci != cout):
                conv(f"{pre}.downsample.0", ci, cout, 1, bias=False)
                bn(f"{pre}.downsample.1", cout)
    conv("conv5.0", 256, 256, 3, bias=False)
    bn("conv5.1", 256)
    for name, cin, cout in (("dec4", 256, 128), ("dec3", 128 + 256, 64), ("dec2", 64 + 128, 64)):
        convt(f"{name}.0", cin, cout, bias=False)
        bn(f"{name}.1", cout)
    for name, n_out in heads(c):
        conv(f"{name}_dec1.0", 64 + 64, HEAD_WIDTH, 3, bias=False)
        bn(f"{name}_dec1.1", HEAD_WIDTH)
        conv(f"{name}_dec0.0", HEAD_WIDTH + 64, n_out, 3)
    specs.append(("aff_scale_const", (1,), "gamma", 0))
    if c.use_GRU:
        n, hd, xd = neighbours(c), c.GRU_hidden_dim, c.GRU_input_dim
        for i, (cin, cout) in enumerate(((n + 1, 16), (16, 2 * hd), (2 * hd, hd))):
            conv(f"encode_aff.{i}.0", cin, cout, 3)
        for i, (cin, cout) in enumerate(((1, 16), (16, 2 * xd), (2 * xd, xd))):
            conv(f"encode_dep.{i}.0", cin, cout, 3)
        for i, (cin, cout) in enumerate(((hd, 2 * hd), (2 * hd, 16), (16, n))):
            convt(f"decode_aff.{i}.0", cin, cout)
        for gate in ("convz", "convr", "convq"):
            conv(f"GRU.{gate}", hd + xd, hd, 3)
    return specs


def _tf32(t: torch.Tensor) -> torch.Tensor:
    bits = t.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


class _RoundTF32(torch.autograd.Function):
    """Rounds to TF32 on the way in and the gradient on the way back."""

    @staticmethod
    def forward(ctx, t):
        return _tf32(t)

    @staticmethod
    def backward(ctx, g):
        return _tf32(g)


def round_tf32(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to TF32 (10 mantissa bits, nearest, ties away), held in
    float32; under autograd its gradient is rounded too."""
    return _RoundTF32.apply(t)


def _shifts(kernel: int):
    r = kernel // 2
    return [(dy, dx) for dy in range(-r, r + 1) for dx in range(-r, r + 1)]


def local_step(feat: torch.Tensor, aff: torch.Tensor, kernel: int) -> torch.Tensor:
    """sum_k aff_k * feat(y + dy_k, x + dx_k) with the border replicated;
    feat (B, H, W), aff (B, K2, H, W)."""
    b, h, w = feat.shape
    r = kernel // 2
    padded = F.pad(feat[:, None], (r, r, r, r), mode="replicate")
    cols = F.unfold(padded, kernel).view(b, kernel * kernel, h, w)
    return (cols * aff).sum(1)


def deform_step(feat: torch.Tensor, off: torch.Tensor, aff: torch.Tensor,
                kernel: int) -> torch.Tensor:
    """sum_k aff_k * bilinear(feat, y + dy_k + oy_k, x + dx_k + ox_k), zero
    outside the image; off (B, 2 K2, H, W) holds neighbour k's (oy, ox) at
    channels (2k, 2k + 1). The fractions are the offsets' own, so that
    they keep the offsets' precision at any column."""
    b, h, w = feat.shape
    flat = feat.reshape(b, h * w)
    ys = torch.arange(h, device=feat.device, dtype=feat.dtype).view(1, h, 1)
    xs = torch.arange(w, device=feat.device, dtype=feat.dtype).view(1, 1, w)
    out = torch.zeros_like(feat)
    for k, (dy, dx) in enumerate(_shifts(kernel)):
        oy, ox = off[:, 2 * k], off[:, 2 * k + 1]
        fy, fx = torch.floor(oy), torch.floor(ox)
        ly, lx = oy - fy, ox - fx
        y0, x0 = ys + dy + fy, xs + dx + fx
        val = torch.zeros_like(feat)
        for cy, cx, wt in ((0, 0, (1 - ly) * (1 - lx)), (0, 1, (1 - ly) * lx),
                           (1, 0, ly * (1 - lx)), (1, 1, ly * lx)):
            yi, xi = y0 + cy, x0 + cx
            inside = (yi >= 0) & (yi <= h - 1) & (xi >= 0) & (xi <= w - 1)
            idx = (yi.clamp(0, h - 1) * w + xi.clamp(0, w - 1)).long()
            tap = torch.gather(flat, 1, idx.reshape(b, -1)).view(b, h, w)
            val = val + wt * torch.where(inside, tap, torch.zeros_like(tap))
        out = out + val * aff[:, k]
    return out


def normalise_affinity(raw: torch.Tensor, gamma: torch.Tensor) -> torch.Tensor:
    """TGASS: tanh(raw) / gamma, divided by max(sum |.| + 1e-4, 1), and the
    reference pixel's 1 - sum inserted in the middle."""
    a = torch.tanh(raw) / (gamma + 1e-8)
    s = torch.maximum(a.abs().sum(1, keepdim=True) + 1e-4, torch.ones_like(a[:, :1]))
    a = a / s
    mid = a.shape[1] // 2
    return torch.cat([a[:, :mid], 1.0 - a.sum(1, keepdim=True), a[:, mid:]], 1)


def forward(p: Dict[str, torch.Tensor], c, rgb: torch.Tensor, dep: torch.Tensor,
            train: bool, tf32: bool = False, propagate=None) -> torch.Tensor:
    """Depth (B, 1, H, W) from rgb (B, 3, H, W) and sparse depth (B, 1, H, W).
    ``train`` normalises with the batch's statistics (biased variance) and
    clamps the offsets to the training window; otherwise the running
    statistics and the exact offsets. ``propagate(feat, off, aff)`` stands
    in for the propagation step where only shapes matter (a FLOP count)."""
    rnd = round_tf32 if tf32 else (lambda t: t)

    def conv(x, name, stride=1):
        wt = p[name + ".weight"]
        return F.conv2d(rnd(x), rnd(wt), p.get(name + ".bias"), stride, wt.shape[-1] // 2)

    def convt(x, name):
        return F.conv_transpose2d(rnd(x), rnd(p[name + ".weight"]), p.get(name + ".bias"),
                                  2, 1, 1)

    def bn(x, name):
        if train:
            mean = x.mean((0, 2, 3))
            var = ((x - mean[:, None, None]) ** 2).mean((0, 2, 3))
        else:
            mean, var = p[name + ".running_mean"], p[name + ".running_var"]
        scale = p[name + ".weight"] / torch.sqrt(var + BN_EPS)
        return (x - mean[:, None, None]) * scale[:, None, None] + p[name + ".bias"][:, None, None]

    def block(x, pre, stride):
        y = F.relu(bn(conv(x, f"{pre}.conv1", stride), f"{pre}.bn1"))
        y = bn(conv(y, f"{pre}.conv2"), f"{pre}.bn2")
        if f"{pre}.downsample.0.weight" in p:
            x = bn(conv(x, f"{pre}.downsample.0", stride), f"{pre}.downsample.1")
        return F.relu(y + x)

    def trim_cat(fd, fe):
        return torch.cat([fd[:, :, :fe.shape[2], :fe.shape[3]], fe], 1)

    # encoder
    if c.use_S2D:
        fe1_dep = s2d(p, dep, conv)
    else:
        fe1_dep = F.relu(conv(dep, "conv1_dep.0"))
    fe1 = torch.cat([F.relu(conv(rgb, "conv1_rgb.0")), fe1_dep], 1)
    feats, x = [], fe1
    for stage, stride in (("conv2", 1), ("conv3", 2), ("conv4", 2)):
        blocks = STAGE_BLOCKS[c.network][int(stage[-1]) - 2]
        for b in range(blocks):
            x = block(x, f"{stage}.{b}", stride if b == 0 else 1)
        feats.append(x)
    fe2, fe3, fe4 = feats
    fe5 = F.relu(bn(conv(fe4, "conv5.0", 2), "conv5.1"))
    # decoder
    fd4 = F.relu(bn(convt(fe5, "dec4.0"), "dec4.1"))
    fd3 = F.relu(bn(convt(trim_cat(fd4, fe4), "dec3.0"), "dec3.1"))
    fd2 = F.relu(bn(convt(trim_cat(fd3, fe3), "dec2.0"), "dec2.1"))
    fd2fe2 = trim_cat(fd2, fe2)
    out = {}
    for name, _ in heads(c):
        h1 = F.relu(bn(conv(fd2fe2, f"{name}_dec1.0"), f"{name}_dec1.1"))
        out[name] = conv(torch.cat([h1, fe1], 1), f"{name}_dec0.0")
    pred = F.relu(out["id"][:, 0])
    raw = out["off_aff"]
    n = neighbours(c)
    off = None
    if c.offset:
        o = raw[:, :2 * n]
        half = 2 * (n // 2)
        off = torch.cat([o[:, :half], torch.zeros_like(o[:, :2]), o[:, half:]], 1)
        raw = raw[:, 2 * n:]
        if train and c.offset_window:
            off = torch.clamp(off, -c.offset_window, c.offset_window)
    gamma = p["aff_scale_const"]
    aff = normalise_affinity(raw, gamma)
    d = dep[:, 0]
    conf = torch.sigmoid(out["cf"][:, 0]) if c.conf_prop else None
    known = (d > 0).to(d.dtype) if c.preserve_input else None
    if known is not None:
        pred = (1 - known) * pred + known * d
        if conf is not None:
            conf = (1 - known) * conf + known
    if c.always_clip:
        pred = torch.maximum(pred, torch.zeros_like(pred))

    def step(pr, a):
        feat = pr * conf if conf is not None else pr
        if propagate is not None:
            y = propagate(feat, off, a)
        elif off is not None:
            y = deform_step(feat, off, a, c.prop_kernel)
        else:
            y = local_step(feat, a, c.prop_kernel)
        if known is not None:
            y = (1 - known) * y + known * d
        return torch.maximum(y, torch.zeros_like(y)) if c.always_clip else y

    h, w = d.shape[1:]
    if c.use_GRU:
        state = torch.tanh(conv(F.relu(conv(F.relu(conv(aff, "encode_aff.0.0", 2)),
                                            "encode_aff.1.0", 2)), "encode_aff.2.0", 2))
    for i in range(c.prop_time):
        pred = step(pred, aff)
        if c.use_GRU and i < c.prop_time - 1:
            x = (pred / c.max_depth)[:, None]
            for j in range(3):
                x = F.relu(conv(x, f"encode_dep.{j}.0", 2))
            state = gru(state, x, conv)
            y = F.relu(convt(F.relu(convt(state, "decode_aff.0.0")), "decode_aff.1.0"))
            aff = normalise_affinity(convt(y, "decode_aff.2.0")[:, :, :h, :w], gamma)
    if not c.always_clip:
        pred = torch.maximum(pred, torch.zeros_like(pred))
    return pred[:, None]


def s2d(p, dep, conv):
    """The sparse-to-dense depth branch: min pools (k 3, 5, 7, 9) of the
    valid depths (0 where a window has none) and max pools (k 11, 13), two
    1x1 convs, then a 3x3 conv over them and the depth."""
    big = torch.where(dep > 0, dep, torch.full_like(dep, float("inf")))
    pools = []
    for k in (3, 5, 7, 9):
        m = -F.max_pool2d(-big, k, 1, k // 2)
        pools.append(torch.where(torch.isinf(m), torch.zeros_like(m), m))
    pools += [F.max_pool2d(dep, k, 1, k // 2) for k in (11, 13)]
    x = F.relu(conv(torch.cat(pools, 1), "S2D.pool_convs.0.0"))
    x = F.relu(conv(x, "S2D.pool_convs.1.0"))
    return F.relu(conv(torch.cat([x, dep], 1), "S2D.conv.0"))


def gru(h, x, conv):
    hx = torch.cat([h, x], 1)
    z = torch.sigmoid(conv(hx, "GRU.convz"))
    r = torch.sigmoid(conv(hx, "GRU.convr"))
    q = torch.tanh(conv(torch.cat([r * h, x], 1), "GRU.convq"))
    return (1 - z) * h + z * q


def loss(pred: torch.Tensor, gt: torch.Tensor, c) -> torch.Tensor:
    """The weighted terms of ``c.loss`` (``"1.0*L1+1.0*L2"``): each the
    per-image mean over valid pixels (gt > 1e-4 after both are clipped to
    [0, max_depth]), summed over the batch and divided by its size."""
    def clip(t):
        return torch.minimum(torch.maximum(t, torch.zeros_like(t)),
                             torch.full_like(t, c.max_depth))

    pc, gc = clip(pred), clip(gt)
    mask = (gc > 1e-4).to(pc.dtype)
    diff = pc - gc
    errs = {"L1": torch.where(diff >= 0, diff, -diff), "L2": diff * diff}
    total = torch.zeros((), dtype=pred.dtype, device=pred.device)
    for term in c.loss.split("+"):
        weight, name = term.split("*")
        per_image = (errs[name.strip()] * mask).sum((1, 2, 3)) / (mask.sum((1, 2, 3)) + 1e-8)
        total = total + float(weight) * per_image.sum()
    return total / pred.shape[0]


def prepare(rgb_u8, dep, bucket: int, device) -> Tuple[torch.Tensor, torch.Tensor]:
    """A serving request (lists of (H, W, 3) uint8 and (H, W) depth numpy
    arrays of one size) as the model's batch: rgb scaled to [0, 1] and
    normalised with the ImageNet statistics, both padded to multiples of
    ``bucket`` (rgb by repeating its last row and column, depth with
    zeros, which observe nothing)."""
    rgb = torch.stack([torch.as_tensor(r) for r in rgb_u8]).to(device).float() / 255.0
    mean = torch.tensor(IMAGENET_MEAN, device=device)
    std = torch.tensor(IMAGENET_STD, device=device)
    rgb = ((rgb - mean) / std).permute(0, 3, 1, 2)
    d = torch.stack([torch.as_tensor(x) for x in dep]).to(device).float()[:, None]
    h, w = d.shape[2:]
    ph, pw = -h % bucket, -w % bucket
    return F.pad(rgb, (0, pw, 0, ph), mode="replicate"), F.pad(d, (0, pw, 0, ph))
