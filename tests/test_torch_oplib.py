"""The port's op library (``nlspn_eccv20_tpu_torch.ops``) held against the
JAX package's (``nlspn_eccv20_tpu.ops``), on the CPU: DCN v1/v2, deformable
PS-RoI pooling, the six DCN modules through ``from_jax_op_variables``, the
space-to-depth convs and the op-level propagation and affinity functions,
forward and gradients.

Inputs come from seeded numpy generators and go to both sides; the JAX
package's NHWC arrays and HWIO weights are transposed to the port's NCHW
and OIHW with numpy. Relative error is max |port - jax| / max |jax|.
Tolerances: 1e-5 for forwards (f32 sums in another order), 1e-4 for
gradients (sums over a batch's pixels). Gradient cases keep sampling
coordinates at least 0.05 from integers, where the bilinear weights kink
and a floor could take the other segment.

With more than one deformable group the JAX package's
``deformable_im2col`` gathers some taps from another group's channels (its
``idx.reshape(b, -1, dg)`` splits the tap axis, not the group axis; its own
test checks the center tap only, which happens to land right). The port
keeps the reference CUDA extension's semantics, and those cases are held
against the JAX op run on each group's channels, offsets and weights alone
(one group each), summed.
"""

import ast
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

import nlspn_eccv20_tpu.ops as jops
import nlspn_eccv20_tpu.ops.spaceconv as jsc
import nlspn_eccv20_tpu_torch.ops as tops
from nlspn_eccv20_tpu_torch.ops import spaceconv as tsc
from nlspn_eccv20_tpu_torch.utils.weights import _convt_w, from_jax_op_variables


def t(a):
    return torch.from_numpy(np.array(a, np.float32))


def nchw(a):
    return np.ascontiguousarray(np.asarray(a).transpose(0, 3, 1, 2))


def oihw(k):
    return np.ascontiguousarray(np.asarray(k).transpose(3, 2, 0, 1))


def assert_rel(name, port, ref, tol):
    port, ref = port.detach().numpy(), np.asarray(ref)
    assert port.shape == ref.shape, (name, port.shape, ref.shape)
    err = np.max(np.abs(port - ref)) / max(np.max(np.abs(ref)), 1e-30)
    assert err <= tol, f"{name}: relative error {err:.3e} > {tol:.0e}"


def jax_vjp(f):
    """A jitted ``run(args, g)`` returning ``f(*args)`` and its VJP at the
    cotangent ``g``: one XLA compilation, where ``jax.vjp`` of a jitted
    ``f`` compiles the forward and its transpose apart."""
    @jax.jit
    def run(args, g):
        out, vjp = jax.vjp(f, *args)
        return out, vjp(g)
    return run


def off_lattice(rng, shape, lo=-2, hi=2):
    """Offsets whose fractional parts lie in [0.05, 0.95]."""
    return (rng.integers(lo, hi + 1, shape)
            + rng.uniform(0.05, 0.95, shape)).astype(np.float32)


# ---- deformable convolution ---------------------------------------------

# (stride, padding, dilation, groups, deformable_groups): the cases of
# tests/test_deform_conv.py
DCN_CASES = [(1, 1, 1, 1, 1), (2, 1, 1, 1, 1), (1, 0, 1, 1, 1), (1, 2, 2, 1, 1),
             (1, 1, 1, 2, 1), (1, 1, 1, 1, 2)]


_JAX_DCN = {}


def _jax_dcn(case):
    """Inputs, kwargs and JAX's (output, VJP) of v1 and of v2 for one case,
    computed once for both versions in one compilation."""
    if case not in _JAX_DCN:
        stride, pad, dil, groups, dg = case
        rng = np.random.default_rng(sum(case))
        b, h, w, c, cout, k = 2, 9, 11, 4, 6, 3
        ho = (h + 2 * pad - ((k - 1) * dil + 1)) // stride + 1
        wo = (w + 2 * pad - ((k - 1) * dil + 1)) // stride + 1
        x = rng.standard_normal((b, h, w, c)).astype(np.float32)
        wgt = (rng.standard_normal((k, k, c // groups, cout)) * 0.3).astype(np.float32)
        bias = (rng.standard_normal(cout) * 0.1).astype(np.float32)
        off = off_lattice(rng, (b, ho, wo, dg * k * k * 2))
        mask = rng.uniform(0.2, 1.0, (b, ho, wo, dg * k * k)).astype(np.float32)
        g = rng.standard_normal((b, ho, wo, cout)).astype(np.float32)
        kw = dict(stride=stride, padding=pad, dilation=dil, groups=groups,
                  deformable_groups=dg)

        def jax_op(modulated, x, o, m, wt, bs, **kw):
            if modulated:
                return jops.modulated_deform_conv(x, o, m, wt, bs, **kw)
            return jops.deform_conv(x, o, wt, bs, **kw)

        def jax_f(modulated, x, o, m, wt, bs):
            if dg == 1:
                return jax_op(modulated, x, o, m, wt, bs, **kw)
            cg, k2 = c // dg, k * k      # one deformable group at a time (groups 1)
            one = dict(kw, deformable_groups=1)
            return bs + sum(jax_op(modulated, x[..., i * cg:(i + 1) * cg],
                                   o[..., 2 * k2 * i:2 * k2 * (i + 1)],
                                   m[..., k2 * i:k2 * (i + 1)],
                                   wt[:, :, i * cg:(i + 1) * cg], None, **one)
                            for i in range(dg))

        @jax.jit
        def both(args, g):       # the inner jits inline: one compilation
            return [jax_vjp(lambda *a, v=v: jax_f(v, *a))(args, g)
                    for v in (False, True)]

        arrays = (x, off, mask, wgt, bias)
        _JAX_DCN[case] = (arrays + (g,), kw, both(arrays, g))
    return _JAX_DCN[case]


@pytest.mark.parametrize("modulated", [False, True], ids=["v1", "v2"])
@pytest.mark.parametrize("case", DCN_CASES, ids=lambda c: "s%dp%dd%dg%ddg%d" % c)
def test_deform_conv_matches_jax(case, modulated):
    (x, off, mask, wgt, bias, g), kw, results = _jax_dcn(case)
    ref, (rx, ro, rm, rw, rb) = results[modulated]

    leaves = [t(nchw(x)), t(nchw(off)), t(nchw(mask)), t(oihw(wgt)), t(bias)]
    for leaf in leaves:
        leaf.requires_grad_(True)
    if modulated:
        out = tops.modulated_deform_conv(*leaves, **kw)
    else:
        out = tops.deform_conv(leaves[0], leaves[1], leaves[3], leaves[4], **kw)
    assert_rel("out", out, nchw(ref), 1e-5)
    used = leaves if modulated else [leaves[i] for i in (0, 1, 3, 4)]
    grads = dict(zip(map(id, used), torch.autograd.grad(out, used, t(nchw(g)))))
    assert_rel("dx", grads[id(leaves[0])], nchw(rx), 1e-4)
    assert_rel("d_offset", grads[id(leaves[1])], nchw(ro), 1e-4)
    assert_rel("dw", grads[id(leaves[3])], oihw(rw), 1e-4)
    assert_rel("db", grads[id(leaves[4])], rb, 1e-4)
    if modulated:
        assert_rel("d_mask", grads[id(leaves[2])], nchw(rm), 1e-4)


def test_deformable_im2col_matches_jax():
    """Columns (B, C, K2, Ho, Wo) against JAX's (B, Ho, Wo, K2, C), two
    deformable groups (JAX's columns of each group alone), offsets past the
    image edge included."""
    rng = np.random.default_rng(11)
    x = rng.standard_normal((1, 7, 8, 4)).astype(np.float32)
    off = (rng.standard_normal((1, 7, 8, 36)) * 3).astype(np.float32)
    mask = rng.uniform(size=(1, 7, 8, 18)).astype(np.float32)
    im2col = jax.jit(lambda *a: jops.deformable_im2col(*a, (3, 3), padding=1))
    ref = np.concatenate([im2col(x[..., 2 * i:2 * i + 2], off[..., 18 * i:18 * (i + 1)],
                                 mask[..., 9 * i:9 * (i + 1)])
                          for i in range(2)], axis=-1)
    out = tops.deformable_im2col(t(nchw(x)), t(nchw(off)), t(nchw(mask)), (3, 3),
                                 padding=1, deformable_groups=2)
    assert_rel("cols", out, np.asarray(ref).transpose(0, 4, 3, 1, 2), 1e-5)


# ---- deformable PS-RoI pooling ---------------------------------------------

ROIS = np.asarray([[0, 2, 2, 11, 11], [1, 0.5, 4.5, 8.5, 13.5],   # .5: half to even
                   [0, 2.5, 1.5, 3.5, 6.5], [1, -3, 5, 20, 9]], np.float32)


@pytest.mark.parametrize("with_trans", [False, True])
def test_deform_psroi_pooling_matches_jax(with_trans):
    rng = np.random.default_rng(12)
    od, gs, ps, part = 3, 2, 4, 4
    data = rng.standard_normal((2, 15, 17, od * gs * gs)).astype(np.float32)
    trans = (rng.uniform(-0.4, 0.4, (4, part, part, 2))).astype(np.float32)
    g = rng.standard_normal((4, ps, ps, od)).astype(np.float32)
    kw = dict(spatial_scale=0.75, output_dim=od, group_size=gs, pooled_size=ps,
              part_size=part, sample_per_part=3, trans_std=0.5 if with_trans else 0.0)

    def jax_f(d, tr):
        return jops.deform_psroi_pooling(d, jnp.asarray(ROIS),
                                         tr if with_trans else None, **kw)

    ref, (rd, rt) = jax_vjp(jax_f)((data, trans), g)
    d_t = t(nchw(data)).requires_grad_(True)
    tr_t = t(trans.transpose(0, 3, 1, 2)).requires_grad_(True)    # (N, 2, part, part)
    out = tops.deform_psroi_pooling(d_t, t(ROIS), tr_t if with_trans else None, **kw)
    assert_rel("out", out, nchw(ref), 1e-5)
    grads = torch.autograd.grad(out, [d_t, tr_t], t(nchw(g)), allow_unused=True)
    assert_rel("d_data", grads[0], nchw(rd), 1e-4)
    if with_trans:
        assert_rel("d_trans", grads[1], np.asarray(rt).transpose(0, 3, 1, 2), 1e-4)


def test_psroi_trans_channel_one_is_dx_and_rounding_is_half_to_even():
    """trans channel 1 moves samples along x, channel 0 along y: on a map
    that rises along x only, the first raises every bin by its shift and
    the second changes nothing. A roi corner at 2.5 rounds to 2 (half to
    even), at 3.5 to 4."""
    ramp = torch.arange(16.0).view(1, 1, 1, 16).expand(1, 1, 16, 16).contiguous()
    rois = torch.tensor([[0, 2, 4, 7, 10]], dtype=torch.float32)
    kw = dict(spatial_scale=1.0, output_dim=1, group_size=1, pooled_size=2,
              trans_std=0.1)
    base = tops.deform_psroi_pooling(ramp, rois, None, **kw)
    shift = torch.zeros(1, 2, 2, 2)
    shift[:, 1] = 1.0                     # dx = 0.1 * roi width 6
    moved = tops.deform_psroi_pooling(ramp, rois, shift, **kw)
    assert torch.allclose(moved, base + 0.6, atol=1e-5)
    assert torch.allclose(tops.deform_psroi_pooling(ramp, rois, shift.flip(1), **kw),
                          base, atol=1e-5)
    one = dict(spatial_scale=1.0, output_dim=1, group_size=1, pooled_size=1,
               sample_per_part=1)
    at = tops.deform_psroi_pooling(ramp, torch.tensor([[0, 2.5, 0, 3.5, 15]]), None, **one)
    # x from round(2.5) - 0.5 = 1.5 to round(4.5) - 0.5 = 3.5: one sample at 2.5
    assert at.item() == pytest.approx(2.5)


# ---- the six modules, through the weight bridge ----------------------------

def _randomize(variables, seed):
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda a: (rng.standard_normal(np.shape(a)) * 0.2).astype(np.float32), variables)


def _module_pair(name):
    """(JAX module, its init variables, the port module, JAX and port
    inputs)."""
    rng = np.random.default_rng(20)
    x = rng.standard_normal((2, 10, 12, 6)).astype(np.float32)
    if name in ("DeformRoIPooling", "DeformRoIPoolingPack"):
        kw = dict(spatial_scale=0.5, pooled_size=3, output_dim=4, group_size=1,
                  trans_std=0.1)
        jm = getattr(jops, name)(**kw, **({"deform_fc_dim": 16} if name.endswith("Pack") else {}))
        tm = getattr(tops, name)(**kw, **({"deform_fc_dim": 16} if name.endswith("Pack") else {}))
        data = rng.standard_normal((2, 16, 16, 4)).astype(np.float32)
        rois = np.asarray([[0, 2, 2, 10, 10], [1, 0, 4, 8, 14]], np.float32)
        jin = (jnp.asarray(data), jnp.asarray(rois))
        if name == "DeformRoIPooling":
            trans = rng.uniform(-0.4, 0.4, (2, 3, 3, 2)).astype(np.float32)
            jin = jin + (jnp.asarray(trans),)
            tin = (t(nchw(data)), t(rois), t(trans.transpose(0, 3, 1, 2)))
        else:
            tin = (t(nchw(data)), t(rois))
    else:
        kw = dict(stride=1, padding=1, groups=2)
        jm = getattr(jops, name)(features=4, **kw)
        tm = getattr(tops, name)(6, 4, **kw)
        jin, tin = (jnp.asarray(x),), (t(nchw(x)),)
        if name in ("DeformConv", "ModulatedDeformConv"):
            off = off_lattice(rng, (2, 10, 12, 18), -1, 1)
            jin, tin = jin + (jnp.asarray(off),), tin + (t(nchw(off)),)
        if name == "ModulatedDeformConv":
            m = rng.uniform(0.2, 1.0, (2, 10, 12, 9)).astype(np.float32)
            jin, tin = jin + (jnp.asarray(m),), tin + (t(nchw(m)),)
    # an RngBitGenerator key: its init compiles in a fraction of threefry's time
    return jm, jax.jit(jm.init)(jax.random.key(0, impl="rbg"), *jin), tm, jin, tin


MODULES = ["DeformConv", "DeformConvPack", "ModulatedDeformConv",
           "ModulatedDeformConvPack", "DeformRoIPooling", "DeformRoIPoolingPack"]


@pytest.mark.parametrize("name", MODULES)
def test_modules_match_jax_through_the_bridge(name):
    """At the JAX module's init (the Packs' zero offset generators) and at
    random weights: the forward, the input's gradient and every parameter's
    gradient (the JAX gradient tree taken through the same bridge)."""
    jm, init, tm, jin, tin = _module_pair(name)
    run = jax_vjp(lambda v, x0: jm.apply(v, x0, *jin[1:]))
    g = np.random.default_rng(22).standard_normal(
        jax.eval_shape(jm.apply, init, *jin).shape).astype(np.float32)
    tin = [a.requires_grad_(True) for a in tin]
    for random in (False, True):
        variables = _randomize(init, 21) if random else init
        tm.load_state_dict(from_jax_op_variables(variables, tm))
        ref, (gv, gx) = run((variables, jin[0]), g)
        out = tm(*tin)
        assert_rel(f"out (random={random})", out, nchw(ref), 1e-5)
        params = dict(tm.named_parameters())
        grads = torch.autograd.grad(out, [tin[0]] + list(params.values()),
                                    t(nchw(g)), allow_unused=True)
        assert_rel("d_input", grads[0], nchw(gx), 1e-4)
        want = from_jax_op_variables(jax.tree_util.tree_map(np.asarray, gv), tm)
        assert set(want) == set(params)
        for (pname, _), got in zip(params.items(), grads[1:]):
            if np.max(np.abs(want[pname].numpy())) == 0:   # fc0, fc1 at init
                assert got is None or torch.count_nonzero(got) == 0, pname
                continue
            assert_rel(f"d_{pname} (random={random})", got, want[pname].numpy(), 1e-4)


def test_packs_at_init_are_their_plain_counterparts():
    """The reference harness's degeneracies, on the port's own init."""
    x = torch.from_numpy(np.random.default_rng(23).standard_normal((2, 6, 10, 12)).astype(np.float32))
    gen = torch.Generator().manual_seed(1)
    m = tops.DeformConvPack(6, 5, generator=gen)
    with torch.no_grad():
        m.bias.uniform_(-1, 1, generator=gen)
        assert_rel("DeformConvPack", m(x), F.conv2d(x, m.weight, m.bias, padding=1).numpy(), 1e-5)
        md = tops.ModulatedDeformConvPack(6, 4, stride=2, generator=gen)
        md.bias.uniform_(-1, 1, generator=gen)
        want = 0.5 * F.conv2d(x, md.weight, None, 2, 1) + md.bias.view(1, -1, 1, 1)
        assert_rel("ModulatedDeformConvPack", md(x), want.numpy(), 1e-5)
        data = torch.randn(2, 8, 16, 16, generator=gen)
        rois = torch.tensor([[0, 2, 2, 10, 10], [1, 0, 4, 8, 14]], dtype=torch.float32)
        pack = tops.DeformRoIPoolingPack(1.0, 4, 8, trans_std=0.1, deform_fc_dim=32)
        plain = tops.DeformRoIPooling(1.0, 4, 8, no_trans=True)
        assert_rel("DeformRoIPoolingPack", pack(data, rois),
                   0.5 * plain(data, rois).numpy(), 1e-6)
    # the weights are U(-1/sqrt(fan_in), 1/sqrt(fan_in)) from the generator
    bound = (6 / 2 * 9) ** -0.5
    dc = tops.DeformConv(6, 8, groups=2, generator=torch.Generator().manual_seed(2))
    assert dc.weight.abs().max() <= bound and dc.weight.abs().max() > 0.8 * bound
    assert torch.equal(dc.bias, torch.zeros(8))


# ---- space-to-depth convs ------------------------------------------------

def test_space_to_depth_keeps_the_phase_major_order():
    x = np.random.default_rng(30).standard_normal((2, 8, 12, 5)).astype(np.float32)
    ref = jsc.space_to_depth(jnp.asarray(x))
    s = tsc.space_to_depth(t(nchw(x)))
    assert torch.equal(s, t(nchw(ref)))
    assert torch.equal(tsc.depth_to_space(s), t(nchw(x)))


@pytest.mark.parametrize("ci,co,h,w", [(1, 16, 12, 16), (7, 3, 8, 10)])
def test_strided_convs_match_jax_and_torch(ci, co, h, w):
    rng = np.random.default_rng(31)
    x = rng.standard_normal((2, h, w, ci)).astype(np.float32)
    k = (rng.standard_normal((3, 3, ci, co)) * 0.3).astype(np.float32)
    k1 = (rng.standard_normal((1, 1, ci, co)) * 0.3).astype(np.float32)
    xt = t(nchw(x)).requires_grad_(True)
    wt = t(oihw(k)).requires_grad_(True)

    g = rng.standard_normal(jax.eval_shape(jsc.conv3x3_s2, x, k).shape).astype(np.float32)
    ref, (rx, rk) = jax_vjp(jsc.conv3x3_s2)((x, k), g)
    out = tsc.conv3x3_s2(xt, wt)
    assert_rel("conv3x3_s2", out, nchw(ref), 1e-5)
    assert_rel("conv3x3_s2 vs F.conv2d", out, F.conv2d(xt, wt, None, 2, 1).detach().numpy(), 1e-5)
    dx, dw = torch.autograd.grad(out, [xt, wt], t(nchw(g)))
    assert_rel("conv3x3_s2 dx", dx, nchw(rx), 1e-4)
    assert_rel("conv3x3_s2 dw", dw, oihw(rk), 1e-4)

    # ConvTranspose2d weight (Ci, Co, 3, 3) <-> the JAX pre-flipped HWIO
    wtt = _convt_w(k).requires_grad_(True)
    g = rng.standard_normal(jax.eval_shape(jsc.convt3x3_s2, x, k).shape).astype(np.float32)
    ref, (rx, rk) = jax_vjp(jsc.convt3x3_s2)((x, k), g)
    out = tsc.convt3x3_s2(xt, wtt)
    assert_rel("convt3x3_s2", out, nchw(ref), 1e-5)
    assert_rel("convt3x3_s2 vs F.conv_transpose2d", out,
               F.conv_transpose2d(xt, wtt, None, 2, 1, 1).detach().numpy(), 1e-5)
    dx, dw = torch.autograd.grad(out, [xt, wtt], t(nchw(g)))
    assert_rel("convt3x3_s2 dx", dx, nchw(rx), 1e-4)
    assert_rel("convt3x3_s2 dw", dw, _convt_w(np.asarray(rk)).numpy(), 1e-4)

    assert_rel("conv1x1_s2", tsc.conv1x1_s2(xt, t(oihw(k1))),
               nchw(jsc.conv1x1_s2(jnp.asarray(x), jnp.asarray(k1))), 1e-5)


# ---- op-level propagation and affinity ------------------------------------

@pytest.mark.parametrize("impl", ["xla", "pallas"])
@pytest.mark.parametrize("kernel", [3, 5])
def test_propagate_step_local_matches_jax(impl, kernel):
    """'auto' is 'xla' at op level, in both packages."""
    rng = np.random.default_rng(40 + kernel)
    feat = rng.standard_normal((2, 7, 9, 1)).astype(np.float32)
    aff = rng.standard_normal((2, 7, 9, kernel * kernel)).astype(np.float32)
    g = rng.standard_normal((2, 7, 9, 1)).astype(np.float32)
    ref, (rf, ra) = jax_vjp(lambda f, a: jops.propagate_step(f, a, kernel=kernel, impl=impl))(
        (feat, aff), g)
    ft, at = t(nchw(feat)).requires_grad_(True), t(nchw(aff)).requires_grad_(True)
    out = tops.propagate_step(ft, at, kernel=kernel, impl=impl)
    assert_rel("out", out, nchw(ref), 1e-5)
    df, da = torch.autograd.grad(out, [ft, at], t(nchw(g)))
    assert_rel("d_feat", df, nchw(rf), 1e-5)
    assert_rel("d_aff", da, nchw(ra), 1e-5)
    assert torch.equal(tops.propagate_step(ft, at, kernel=kernel, impl="auto"),
                       tops.propagate_local(ft, at, kernel))
    assert_rel("propagate_local", tops.propagate_local(ft, at, kernel), nchw(ref), 1e-5)


_JAX_DEFORMABLE = {}


def _jax_deformable(fallback, radius, past):
    """Inputs and JAX's output and VJP of one deformable case, computed
    once for both impls (the JAX op's scan form of the window, the same math
    as its unrolled one and quicker to compile). Offsets inside (-1, 1), or
    up to +-3 ("past"), their fractional parts in [0.05, 0.95]."""
    key = (fallback, radius, past)
    if key not in _JAX_DEFORMABLE:
        rng = np.random.default_rng(50)
        feat = rng.standard_normal((2, 6, 8, 1)).astype(np.float32)
        aff = rng.uniform(size=(2, 6, 8, 9)).astype(np.float32)
        off = off_lattice(rng, (2, 6, 8, 18), -3 if past else -1, 2 if past else 0)
        g = rng.standard_normal((2, 6, 8, 1)).astype(np.float32)

        ref, grads = jax_vjp(lambda *x: jops.propagate_deformable(
            *x, radius=radius, impl="xla", fallback=fallback,
            neighbor_loop="scan"))((feat, off, aff), g)
        _JAX_DEFORMABLE[key] = ((feat, off, aff, g), ref, grads)
    return _JAX_DEFORMABLE[key]


@pytest.mark.parametrize("fallback,radius,past", [
    (True, 1, False),     # inference, offsets inside the window
    (True, 1, True),      # inference, some past it: the exact gather
    (False, 1, True),     # training: clamped, then the window
    (True, None, True),   # the exact gather
])
@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_propagate_deformable_matches_jax(fallback, radius, past, impl):
    """Inference runs the exact gather in the port; JAX's ``lax.cond`` takes
    its window form when every offset is inside: the same values, and the
    same gradients away from integer offsets."""
    (feat, off, aff, g), ref, (rf, ro, ra) = _jax_deformable(fallback, radius, past)
    leaves = [t(nchw(a)).requires_grad_(True) for a in (feat, off, aff)]
    out = tops.propagate_deformable(*leaves, radius=radius, impl=impl,
                                    fallback=fallback)
    assert_rel("out", out, nchw(ref), 1e-5)
    for name, got, want in zip(("feat", "offset", "aff"),
                               torch.autograd.grad(out, leaves, t(nchw(g))), (rf, ro, ra)):
        assert_rel(f"d_{name}", got, nchw(want), 1e-4)
    if fallback:  # propagate_step routes the offset path here
        step = tops.propagate_step(leaves[0], leaves[2], leaves[1], radius=radius,
                                   impl=impl)
        assert torch.equal(step, out)


@pytest.mark.parametrize("fallback", [True, False])
def test_propagate_deformable_impls_share_one_semantics(fallback):
    """'xla' and 'pallas' (on the CPU, K7's plain version and its VJP) give
    the same output and gradients at integer offsets too, where the exact
    gather's and the window's tie rules differ; 1e-6."""
    rng = np.random.default_rng(55)
    off = rng.integers(-2, 3, (2, 18, 6, 8)).astype(np.float32)
    feat, aff = rng.standard_normal((2, 1, 6, 8)), rng.uniform(size=(2, 9, 6, 8))
    g = t(rng.standard_normal((2, 1, 6, 8)))
    results = []
    for impl in ("xla", "pallas"):
        leaves = [t(a).requires_grad_(True) for a in (feat, off, aff)]
        out = tops.propagate_deformable(*leaves, radius=1, impl=impl, fallback=fallback)
        results.append([out] + list(torch.autograd.grad(out, leaves, g)))
    for name, a, b in zip(("out", "d_feat", "d_offset", "d_aff"), *results):
        assert_rel(name, a, b.detach().numpy(), 1e-6)


def test_propagate_step_rejects_unknown_impl():
    with pytest.raises(ValueError):
        tops.propagate_step(torch.zeros(1, 1, 4, 4), torch.zeros(1, 9, 4, 4), impl="cuda")


@pytest.mark.parametrize("mode", ["AS", "ASS", "TC", "TGASS"])
@pytest.mark.parametrize("insert_center", [False, True])
def test_affinity_functions_match_jax(mode, insert_center):
    rng = np.random.default_rng(60)
    raw = (rng.standard_normal((2, 4, 5, 8)) * 2).astype(np.float32)
    ref = jops.normalize_affinity(jnp.asarray(raw), jnp.float32(4.0), mode,
                                  insert_center=insert_center)
    out = tops.normalize_affinity(t(nchw(raw)), torch.tensor(4.0), mode,
                                  insert_center=insert_center)
    assert_rel("normalize", out, nchw(ref), 1e-6)
    assert_rel("insert_center_affinity", tops.insert_center_affinity(t(nchw(raw))),
               nchw(jops.insert_center_affinity(jnp.asarray(raw))), 1e-6)
    assert torch.equal(tops.insert_center_offset(t(nchw(raw))),
                       t(nchw(jops.insert_center_offset(jnp.asarray(raw)))))


# ---- the public surface ------------------------------------------------------

def test_port_exports_every_name_of_the_jax_op_library():
    path = os.path.join(os.path.dirname(jops.__file__), "__init__.py")
    with open(path) as f:
        tree = ast.parse(f.read())
    names = {a.asname or a.name for node in ast.walk(tree)
             if isinstance(node, ast.ImportFrom) for a in node.names}
    assert len(names) == 17
    missing = sorted(n for n in names | {"small_conv3x3_planar"} if not hasattr(tops, n))
    assert not missing, missing
