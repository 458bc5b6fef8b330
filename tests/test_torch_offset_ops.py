"""The port's ``--offset`` ops held against the JAX package, on the CPU.

The deformable step (``ops/kernels/deform_prop.py``, K7 and K8 on the card)
runs its plain versions on CPU tensors. Each case feeds the same seeded
numpy inputs to the port and to the JAX package:

- forward in training (offsets clamped to the window) against the JAX
  windowed mirror ``_pure_windowed_planar`` and the TPU kernel
  ``_deform_op`` in interpret mode; in eval against the JAX package's
  ``propagate_deformable`` with its runtime exact fallback; the exact
  gather against ``propagate_deformable_exact``; all to 1e-5;
- the plain backward (K8's) against ``jax.vjp`` of the windowed mirror, on
  offsets that are random, integers, zeros, exactly +-R after the clamp
  and beyond it, to 1e-5 of each gradient's largest entry; also at R = 4
  (3x3 and 5x5), on a plane wider than K8's tile and its halo, on
  converging offsets and on unclamped offsets past the window; with the conf
  weighting, the preserve blend and the clip's ties against ``jax.vjp`` of
  the JAX model's own step (``_prop_and_blend``), to rtol 2e-4, atol 2e-5
  as ``tests/test_deform_prop_pallas.py`` holds the TPU kernel;
- the unclamped step's backward (``offset_window=0`` in training, radius
  None) against ``jax.vjp`` of ``propagate_deformable_exact`` and of the
  JAX model's step at window 0, on offsets kept away from integers: there
  the port takes the fraction of the offset alone and JAX that of the
  absolute coordinate, and the two may take different segments.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nlspn_eccv20_tpu.config import Config as JaxConfig
from nlspn_eccv20_tpu.models.nlspn import _prop_and_blend
from nlspn_eccv20_tpu.ops.affinity import insert_center_offset as jax_insert_center_offset
from nlspn_eccv20_tpu.ops.pallas.deform_prop import _deform_op, _pure_windowed_planar
from nlspn_eccv20_tpu.ops.propagate import (
    propagate_deformable,
    propagate_deformable_exact,
    propagate_deformable_windowed_scan,
)
from nlspn_eccv20_tpu_torch.ops.affinity import insert_center_offset
from nlspn_eccv20_tpu_torch.ops.kernels.deform_prop import (
    deform_prop,
    deform_prop_bwd,
    deform_prop_bwd_plain,
    deform_prop_plain,
)
from nlspn_eccv20_tpu_torch.ops.propagate import (
    clamp_offsets,
    propagate_deformable_exact_planar,
    propagate_deformable_planar,
    propagate_deformable_windowed_planar,
)


def t(a):
    return torch.from_numpy(np.asarray(a, np.float32))


def leaf(a):
    return t(a).requires_grad_(True)


def nhwc(x):
    return jnp.moveaxis(jnp.asarray(x), 1, -1)


def assert_rel(name, port, ref, tol):
    """max |port - ref| / max |ref| <= tol."""
    port, ref = port.detach().numpy(), np.asarray(ref)
    assert port.shape == ref.shape, (name, port.shape, ref.shape)
    err = np.max(np.abs(port - ref))
    assert err <= tol * max(np.max(np.abs(ref)), 1e-30), \
        f"{name}: max abs err {err:.3e}, scale {np.max(np.abs(ref)):.3e}"


def inputs(b, h, w, kernel, scale, seed):
    rng = np.random.default_rng(seed)
    k2 = kernel * kernel
    return (rng.uniform(0.0, 5.0, (b, h, w)).astype(np.float32),
            (rng.standard_normal((b, 2 * k2, h, w)) * scale).astype(np.float32),
            (rng.standard_normal((b, k2, h, w)) / k2).astype(np.float32))


def tie_offsets(rng, b, k2, h, w, radius):
    """Offsets of every kind in one tensor: random, beyond the window in
    both directions (the clamp puts them on +-R), integers, zeros, exactly
    +-R, and integers +-1 off the window's edge."""
    off = rng.standard_normal((b, 2 * k2, h, w)).astype(np.float32)
    q = h // 6
    off[:, :, :q] *= 3 * radius
    off[:, :, q:2 * q] = rng.integers(-radius, radius + 1, off[:, :, q:2 * q].shape)
    off[:, :, 2 * q:3 * q] = 0.0
    off[:, :, 3 * q:4 * q] = rng.choice([-radius, radius], off[:, :, 3 * q:4 * q].shape)
    off[:, :, 4 * q:5 * q] = rng.choice([-radius - 1, -radius + 1, radius - 1],
                                        off[:, :, 4 * q:5 * q].shape)
    return off


# ---- layouts -----------------------------------------------------------

@pytest.mark.parametrize("n", [8, 24])
def test_insert_center_offset_matches_jax(n):
    off = np.random.default_rng(n).standard_normal((2, 2 * n, 3, 5)).astype(np.float32)
    ref = jax_insert_center_offset(nhwc(off))
    out = insert_center_offset(t(off))
    assert out.shape == (2, 2 * n + 2, 3, 5)
    np.testing.assert_array_equal(out.permute(0, 2, 3, 1).numpy(), np.asarray(ref))
    assert torch.count_nonzero(out[:, n:n + 2]) == 0


# ---- forward -----------------------------------------------------------

@pytest.mark.parametrize("kernel,radius,scale,escapes", [
    (3, 4, 0.8, False),    # the fork's window, offsets inside it
    (3, 4, 6.0, True),     # offsets escaping it
    (3, 2, 0.4, False),    # offset_window 2
    (5, 2, 3.0, True),     # prop_kernel 5, escaping
])
def test_forward_matches_jax(kernel, radius, scale, escapes):
    feat, off, aff = inputs(2, 10, 13, kernel, scale, seed=kernel + radius)
    j = tuple(map(jnp.asarray, (feat, off, aff)))
    # training: the window form of the clamped offsets, as the mirror and
    # the TPU kernel compute it
    ref = _pure_windowed_planar(j[0], jnp.clip(j[1], -radius, radius), j[2],
                                kernel, radius)
    port = deform_prop(t(feat), clamp_offsets(t(off), radius), t(aff),
                       kernel=kernel, radius=radius)
    assert_rel("train", port, ref, 1e-5)
    assert_rel("train, TPU kernel", port, _deform_op(
        j[0], jnp.clip(j[1], -radius, radius), j[2], kernel, radius), 1e-5)
    assert_rel("train, router", propagate_deformable_planar(
        t(feat), t(off), t(aff), kernel, radius, train=True), ref, 1e-5)
    # eval: the runtime switch (windowed inside the window, exact beyond)
    ref = propagate_deformable(j[0][..., None], nhwc(off), nhwc(aff), kernel,
                               radius, fallback=True)[..., 0]
    assert (np.max(np.abs(off)) > radius) == escapes
    assert_rel("eval", deform_prop(t(feat), t(off), t(aff), kernel=kernel), ref, 1e-5)
    assert_rel("eval, router", propagate_deformable_planar(
        t(feat), t(off), t(aff), kernel, radius, train=False), ref, 1e-5)


@pytest.mark.parametrize("kernel", [3, 5])
def test_exact_gather_matches_jax(kernel):
    """Offsets far beyond the image too: zeros outside, for any offset."""
    feat, off, aff = inputs(2, 9, 14, kernel, 4.0, seed=20 + kernel)
    off[:, :, 0, :3] = [1e3, -1e6, 40.0]
    ref = propagate_deformable_exact(jnp.asarray(feat)[..., None], nhwc(off),
                                     nhwc(aff), kernel)[..., 0]
    assert_rel("exact", propagate_deformable_exact_planar(
        t(feat), t(off), t(aff), kernel), ref, 1e-5)
    assert_rel("radius 0", propagate_deformable_planar(
        t(feat), t(off), t(aff), kernel, radius=0), ref, 1e-5)


@pytest.mark.parametrize("preserve,clip", [(True, False), (False, True)])
def test_fused_step_matches_jax_model_step(preserve, clip):
    """conf weighting, blend and clip fused around the gather, in eval."""
    rng = np.random.default_rng(5)
    b, h, w = 2, 9, 12
    pred, off, aff = inputs(b, h, w, 3, 1.0, seed=6)
    pred -= 1.0
    conf = rng.uniform(0.0, 1.0, (b, h, w)).astype(np.float32)
    dep = ((rng.random((b, h, w)) > 0.8) * rng.uniform(0.5, 5.0, (b, h, w))
           ).astype(np.float32)
    cfg = JaxConfig(offset=True, offset_window=2, preserve_input=preserve,
                    always_clip=clip)
    ref = _prop_and_blend(cfg, jnp.asarray(pred), jnp.asarray(aff),
                          jnp.asarray(conf), jnp.asarray(dep), nhwc(off))
    launches = deform_prop.launches
    for fn in (deform_prop, deform_prop_plain):
        out = fn(t(pred), t(off), t(aff), t(conf), t(dep) if preserve else None,
                 kernel=3, preserve=preserve, clip=clip)
        assert_rel(fn.__name__, out, ref, 1e-5)
    assert deform_prop.launches == launches  # the CPU runs no kernel
    if preserve:
        m = dep > 0
        assert np.array_equal(out.numpy()[m], dep[m])


# ---- backward ----------------------------------------------------------

def test_gradients_match_windowed_vjp_at_ties():
    """The plain backward against jax.vjp of clip-then-window: each kind of
    offset of ``tie_offsets``, where the slope takes its JAX tie values
    (+1 for |t| at t == 0, 1/2 at |t| == 1, nothing from u = -R - 1 for an
    offset clamped onto -R) and the clamp passes 1/2 at +-R."""
    kernel, radius = 3, 2
    rng = np.random.default_rng(11)
    b, h, w = 1, 12, 10
    feat = rng.standard_normal((b, h, w)).astype(np.float32)
    off = tie_offsets(rng, b, 9, h, w, radius)
    aff = rng.standard_normal((b, 9, h, w)).astype(np.float32)
    g = rng.standard_normal((b, h, w)).astype(np.float32)

    def mirror(f, o, a):
        return _pure_windowed_planar(f, jnp.clip(o, -radius, radius), a, kernel,
                                     radius)

    out_j, vjp = jax.vjp(mirror, *map(jnp.asarray, (feat, off, aff)))
    ref = vjp(jnp.asarray(g))

    leaves = [leaf(feat), leaf(off), leaf(aff)]
    out = deform_prop(leaves[0], clamp_offsets(leaves[1], radius), leaves[2],
                      kernel=kernel, radius=radius)
    assert_rel("out", out, out_j, 1e-5)
    grads = torch.autograd.grad(out, leaves, t(g))
    for name, gp, gr in zip(("d_feat", "d_off", "d_aff"), grads, ref):
        assert_rel(name, gp, gr, 1e-5)
    # the window's autograd gives the same: torch.maximum and where(t >= 0)
    leaves2 = [leaf(feat), leaf(off), leaf(aff)]
    out2 = propagate_deformable_planar(*leaves2, kernel, radius, train=True)
    for name, gp, gr in zip(("d_feat", "d_off", "d_aff"),
                            torch.autograd.grad(out2, leaves2, t(g)), ref):
        assert_rel(f"windowed {name}", gp, gr, 1e-5)
    d_off = np.asarray(ref[1])
    assert np.all(d_off[np.abs(off) > radius] == 0.0)
    assert np.any(d_off[np.abs(off) == radius] != 0.0)


def converging_offsets(b, kernel, h, w, radius):
    """Each output points each neighbour at the nearest node of a grid 2R
    apart, a quarter pixel on, clamped to the window: up to (2R)^2 outputs
    of a neighbour share one corner."""
    step = 2 * radius
    ys, xs = np.mgrid[0:h, 0:w].astype(np.float32)
    ny = np.round(ys / step) * step + 0.25
    nx = np.round(xs / step) * step + 0.25
    off = np.zeros((b, 2 * kernel * kernel, h, w), np.float32)
    r = kernel // 2
    for k in range(kernel * kernel):
        off[:, 2 * k] = ny - ys - (k // kernel - r)
        off[:, 2 * k + 1] = nx - xs - (k % kernel - r)
    return np.clip(off, -radius, radius)


@pytest.mark.parametrize("kernel,radius,w,offsets", [
    (3, 4, 12, "clamped"),     # the fork's window
    (5, 4, 12, "clamped"),     # prop_kernel 5 at the fork's window
    (3, 1, 40, "clamped"),     # wider than 32 + 2R + 1: one 32-wide source
                               # tile reads outputs of several
    (3, 2, 14, "converging"),  # many outputs at one source pixel
    (3, 2, 14, "beyond"),      # past the window, unclamped (the devtools
                               # drop-in's backward)
])
def test_plain_backward_matches_windowed_vjp(kernel, radius, w, offsets):
    """The plain backward (K8's) against jax.vjp of the window form at the
    shapes where K8's binned gather is risky on the card, each gradient to
    1e-5 of its largest entry. The reference is the scan over neighbours
    (``propagate_deformable_windowed_scan``): ``_pure_windowed_planar``'s
    math in one traced neighbour body, which XLA compiles in seconds where
    the unrolled mirror takes 16-27 s at R = 4; the two differ only at
    offsets an ulp off an integer (see the test below), which these are
    not."""
    rng = np.random.default_rng(50 + kernel + radius)
    b, h, k2 = 1, 10, kernel * kernel
    feat = rng.standard_normal((b, h, w)).astype(np.float32)
    aff = (rng.standard_normal((b, k2, h, w)) / k2).astype(np.float32)
    g = rng.standard_normal((b, h, w)).astype(np.float32)
    if offsets == "converging":
        off = converging_offsets(b, kernel, h, w, radius)
    else:
        scale = 1.5 if offsets == "clamped" else 3.0 * (radius + 1)
        off = (rng.standard_normal((b, 2 * k2, h, w)) * scale).astype(np.float32)
        if offsets == "clamped":
            off = np.clip(off, -radius, radius)
    assert (np.max(np.abs(off)) > radius + 1) == (offsets == "beyond")

    def scan_form(f, o, a):
        return propagate_deformable_windowed_scan(
            f[..., None], jnp.moveaxis(o, 1, -1), jnp.moveaxis(a, 1, -1), kernel,
            radius)[..., 0]

    ref = jax.jit(lambda *x: jax.vjp(scan_form, *x)[1](jnp.asarray(g)))(
        *map(jnp.asarray, (feat, off, aff)))
    got = deform_prop_bwd_plain(t(g), t(feat), t(off), t(aff), None, None,
                                kernel=kernel, radius=radius, preserve=False,
                                clip=False)
    for name, gp, gr in zip(("d_feat", "d_off", "d_aff"), got, ref):
        assert_rel(name, gp, gr, 1e-5)


def test_gradients_follow_the_relative_window_at_rounding_ties():
    """Offsets a few ulps off an integer, where o - u rounds to exactly
    +-1 for a u two rows away (o = -4e-8: o - 1 == -1.0, slope 1/2): the
    plain backward takes the slope of o - u over the window around the
    kernel shift, as the TPU kernel and the JAX scan form do (the unrolled
    mirror rounds o + dy first and differs there)."""
    rng = np.random.default_rng(12)
    b, h, w, radius = 1, 8, 9, 2
    feat = rng.standard_normal((b, h, w)).astype(np.float32)
    off = rng.integers(-radius + 1, radius, (b, 18, h, w)).astype(np.float32)
    off += rng.choice(np.asarray([-6e-8, -4e-8, 0.0, 4e-8, 6e-8], np.float32),
                      off.shape)
    aff = rng.standard_normal((b, 9, h, w)).astype(np.float32)
    g = rng.standard_normal((b, h, w)).astype(np.float32)

    def scan_form(f, o, a):
        return propagate_deformable_windowed_scan(
            f[..., None], jnp.moveaxis(o, 1, -1), jnp.moveaxis(a, 1, -1), 3,
            radius)[..., 0]

    ref = jax.jit(lambda *x: jax.vjp(scan_form, *x)[1](jnp.asarray(g)))(
        *map(jnp.asarray, (feat, off, aff)))
    got = deform_prop_bwd_plain(t(g), t(feat), t(off), t(aff), None, None,
                                kernel=3, radius=radius, preserve=False,
                                clip=False)
    for name, gp, gr in zip(("d_feat", "d_off", "d_aff"), got, ref):
        assert_rel(name, gp, gr, 1e-5)


@pytest.mark.parametrize("kernel,conf,preserve,clip", [
    (3, True, True, False),     # the fork default's step
    (5, False, False, True),    # prop_kernel 5, the clip's ties
])
def test_fused_gradients_match_jax_model_step(kernel, conf, preserve, clip):
    """d_pred, d_off, d_aff, d_conf of the whole train-mode step (clamp,
    conf, gather, blend, clip) against jax.vjp of the JAX model's
    ``_prop_and_blend(train=True)``, whose gather is the windowed form
    (its scan over neighbours: the same math in fewer XLA ops). A zero
    corner with zero offsets gives exact zeros before the clip."""
    rng = np.random.default_rng(30 + kernel)
    b, h, w, k2, radius = 2, 9, 11, kernel * kernel, 2
    pred, off, aff = inputs(b, h, w, kernel, 1.5, seed=31)
    pred -= 1.0
    pred[:, :4, :5] = 0.0
    off[:, :, :4, :5] = 0.0
    cf = rng.uniform(0.1, 1.0, (b, h, w)).astype(np.float32)
    dep = ((rng.random((b, h, w)) > 0.8) * rng.uniform(0.5, 5.0, (b, h, w))
           ).astype(np.float32)
    g = rng.standard_normal((b, h, w)).astype(np.float32)
    cfg = JaxConfig(offset=True, offset_window=radius, prop_kernel=kernel,
                    preserve_input=preserve, always_clip=clip,
                    offset_neighbor_loop="scan")

    def jax_step(p, o, a, *c):
        return _prop_and_blend(cfg, p, a, c[0] if conf else None,
                               jnp.asarray(dep), jnp.moveaxis(o, 1, -1),
                               train=True)

    @jax.jit
    def forward_and_vjp(*primals):
        out, vjp = jax.vjp(jax_step, *primals)
        return out, vjp(jnp.asarray(g))

    primals = (pred, off, aff) + ((cf,) if conf else ())
    out_j, ref = forward_and_vjp(*map(jnp.asarray, primals))
    if clip:
        assert np.any(np.asarray(out_j) == 0.0)  # the ties are exercised

    leaves = [leaf(a) for a in primals]
    out = deform_prop(leaves[0], clamp_offsets(leaves[1], radius), leaves[2],
                      leaves[3] if conf else None, t(dep) if preserve else None,
                      kernel=kernel, radius=radius, preserve=preserve, clip=clip)
    np.testing.assert_allclose(out.detach().numpy(), out_j, rtol=1e-5, atol=1e-5)
    grads = torch.autograd.grad(out, leaves, t(g))
    for name, gp, gr in zip(("pred", "off", "aff", "conf"), grads, ref):
        np.testing.assert_allclose(gp.numpy(), gr, rtol=2e-4, atol=2e-5,
                                   err_msg=f"d_{name}")
    # the wrapper's CPU path is the plain backward, and so is the plain op's
    off_c = clamp_offsets(t(off), radius)
    args = (t(g), t(pred), off_c, t(aff), t(cf) if conf else None,
            t(dep) if preserve else None)
    kw = dict(kernel=kernel, radius=radius, preserve=preserve, clip=clip)
    launches = deform_prop_bwd.launches
    direct = deform_prop_bwd(*args, **kw)
    assert deform_prop_bwd.launches == launches
    for a, d in zip(direct, deform_prop_bwd_plain(*args, **kw)):
        assert (a is None and d is None) or torch.equal(a, d)
    leaves = [leaf(a) for a in primals]
    out = deform_prop_plain(leaves[0], clamp_offsets(leaves[1], radius), leaves[2],
                            leaves[3] if conf else None,
                            t(dep) if preserve else None, kernel=kernel,
                            radius=radius, preserve=preserve, clip=clip)
    for gp, gd in zip(torch.autograd.grad(out, leaves, t(g)), grads):
        assert torch.equal(gp, gd)


def test_clamp_passes_half_the_gradient_at_the_window_edge():
    x = np.asarray([-5.0, -2.0, -1.5, 0.0, 2.0, 7.0], np.float32)
    ref = jax.grad(lambda v: jnp.sum(jnp.clip(v, -2, 2) * 3.0))(jnp.asarray(x))
    p = leaf(x)
    (grad,) = torch.autograd.grad((clamp_offsets(p, 2) * 3.0).sum(), [p])
    np.testing.assert_array_equal(grad.numpy(), np.asarray(ref))
    np.testing.assert_array_equal(grad.numpy(), [0.0, 1.5, 3.0, 3.0, 1.5, 0.0])


def test_eval_step_has_no_backward_and_window_0_does_not_train():
    """The unclamped step (radius None) differentiates as the exact gather,
    whose autograd is its backward, and the router's window 0 trains the
    exact gather on unclamped offsets, as the JAX package's radius=None."""
    feat, off, aff = inputs(1, 5, 6, 3, 1.0, seed=2)
    leaves = [leaf(feat), leaf(off), leaf(aff)]
    out = deform_prop(*leaves, kernel=3)                      # radius None
    grads = torch.autograd.grad(out.sum(), leaves)
    leaves2 = [leaf(feat), leaf(off), leaf(aff)]
    exact = propagate_deformable_planar(*leaves2, 3, 0, train=True)
    assert torch.equal(exact, out)
    for gp, ge in zip(grads, torch.autograd.grad(exact.sum(), leaves2)):
        np.testing.assert_allclose(gp.numpy(), ge.numpy(), rtol=1e-6, atol=1e-7)
    with pytest.raises(ValueError):
        deform_prop(t(feat), t(off), t(aff), kernel=3, preserve=True)


def off_integer_offsets(rng, shape, span):
    """Offsets at least 0.05 from any integer, in (-span, span)."""
    whole = rng.integers(-span, span, shape)
    return (whole + rng.uniform(0.05, 0.95, shape)).astype(np.float32)


@pytest.mark.parametrize("kernel,fused", [(3, False), (5, False), (3, True)])
def test_exact_gather_gradients_match_jax_vjp(kernel, fused):
    """The unclamped step's (d_pred, d_off, d_aff[, d_conf]) against
    jax.vjp of ``propagate_deformable_exact`` (XLA's autodiff, the floor
    treated as a constant), and fused with conf, blend and the clip's ties
    against the JAX model's train-mode step at ``offset_window=0``; offsets
    reach past the image."""
    rng = np.random.default_rng(40 + kernel)
    b, h, w, k2 = 2, 9, 11, kernel * kernel
    feat = rng.uniform(-1.0, 4.0, (b, h, w)).astype(np.float32)
    off = off_integer_offsets(rng, (b, 2 * k2, h, w), 3)
    aff = (rng.standard_normal((b, k2, h, w)) / k2).astype(np.float32)
    g = rng.standard_normal((b, h, w)).astype(np.float32)
    if not fused:
        def jax_step(f, o, a):
            return propagate_deformable_exact(f[..., None], jnp.moveaxis(o, 1, -1),
                                              jnp.moveaxis(a, 1, -1), kernel)[..., 0]
        primals = (feat, off, aff)
        port_kw = dict(kernel=kernel)
    else:
        feat[:, :5, :6] = 0.0                     # exact zeros before the clip
        off[:, :, :5, :6] = rng.uniform(-0.45, 0.45, off[:, :, :5, :6].shape)
        aff = np.abs(aff)
        cf = rng.uniform(0.1, 1.0, (b, h, w)).astype(np.float32)
        dep = ((rng.random((b, h, w)) > 0.8) * rng.uniform(0.5, 5.0, (b, h, w))
               ).astype(np.float32)
        dep[:, :5, :6] = 0.0
        cfg = JaxConfig(offset=True, offset_window=0, always_clip=True)

        def jax_step(p, o, a, c):
            return _prop_and_blend(cfg, p, a, c, jnp.asarray(dep),
                                   jnp.moveaxis(o, 1, -1), train=True)
        primals = (feat, off, aff, cf)
        port_kw = dict(kernel=kernel, dep=t(dep), preserve=True, clip=True)

    out_j, vjp = jax.vjp(jax_step, *map(jnp.asarray, primals))
    ref = vjp(jnp.asarray(g))
    if fused:
        assert np.any(np.asarray(out_j) == 0.0)    # the ties are exercised
    leaves = [leaf(a) for a in primals]
    out = deform_prop(*leaves[:3], leaves[3] if fused else None, **port_kw)
    assert_rel("out", out, out_j, 1e-5)
    for name, gp, gr in zip(("d_pred", "d_off", "d_aff", "d_conf"),
                            torch.autograd.grad(out, leaves, t(g)), ref):
        np.testing.assert_allclose(gp.numpy(), gr, rtol=2e-4, atol=2e-5,
                                   err_msg=name)


def test_exact_gather_gradients_take_the_offsets_own_segment():
    """At an offset a few ulps below an integer the port's exact gradient is
    the slope of the segment that the offset's own floor picks: at
    o = -4e-8 that of [-1, 0], as at o = -0.5. JAX floors the absolute
    coordinate y + dy + o, which rounds up to y + dy from y + dy = 2 on, so
    its slope there is that of [0, 1]."""
    rng = np.random.default_rng(13)
    b, h, w = 1, 8, 9
    feat = rng.standard_normal((b, h, w)).astype(np.float32)
    aff = rng.standard_normal((b, 9, h, w)).astype(np.float32)
    g = rng.standard_normal((b, h, w)).astype(np.float32)

    def d_off(oy, backend):
        off = np.full((b, 18, h, w), 0.3, np.float32)
        off[:, 0::2] = oy
        if backend == "port":
            leaves = [t(feat), leaf(off), t(aff)]
            out = deform_prop(*leaves, kernel=3)
            return torch.autograd.grad(out, leaves[1], t(g))[0].numpy()[:, 0::2]
        _, vjp = jax.vjp(lambda o: propagate_deformable_exact(
            jnp.asarray(feat)[..., None], jnp.moveaxis(o, 1, -1),
            nhwc(aff), 3)[..., 0], jnp.asarray(off))
        return np.asarray(vjp(jnp.asarray(g))[0])[:, 0::2]

    near = np.float32(-4e-8)
    np.testing.assert_allclose(d_off(near, "port"), d_off(-0.5, "port"),
                               rtol=1e-5, atol=1e-6)
    inner = (slice(None), slice(None), slice(3, None))     # y + dy >= 2
    np.testing.assert_allclose(d_off(near, "jax")[inner], d_off(0.5, "jax")[inner],
                               rtol=1e-5, atol=1e-6)
    assert not np.allclose(d_off(near, "port"), d_off(near, "jax"), atol=1e-3)


def test_windowed_form_equals_exact_gather_inside_the_window():
    feat, off, aff = inputs(2, 8, 9, 3, 0.8, seed=4)
    off = np.clip(off, -2, 2)
    a = propagate_deformable_exact_planar(t(feat), t(off), t(aff), 3)
    b = propagate_deformable_windowed_planar(t(feat), t(off), t(aff), 3, 2)
    assert_rel("window vs exact", b, a, 1e-5)
