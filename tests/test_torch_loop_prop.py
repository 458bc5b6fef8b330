"""The port's whole-loop propagation op held against the JAX package, on the
CPU.

``prop_loop`` (``ops/kernels/prop_loop.py``, K6 and K6b on the card) runs its
plain versions on CPU tensors. Each case feeds the same seeded numpy inputs
to the port and to the JAX package's ``propagate_loop_pallas_planar``, which
runs the TPU kernel ``_loop_kernel`` in interpret mode on the CPU and whose
VJP is ``jax.vjp`` of the pure mirror ``_pure_loop_planar``. Tolerances as
the model tests: forward 2e-4 and gradients 5e-3 of the largest entry
(f32 sums of the same products in another order; observed about 1e-6).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nlspn_eccv20_tpu.ops.pallas.local_prop import propagate_loop_pallas_planar
from nlspn_eccv20_tpu_torch.ops.kernels.prop_loop import (
    _bwd_floats,
    plan,
    prop_loop,
    prop_loop_bwd,
    prop_loop_bwd_plain,
    prop_loop_plain,
)
from nlspn_eccv20_tpu_torch.ops.kernels.prop_step import prop_step_plain

FORWARD_TOL, GRAD_TOL = 2e-4, 5e-3


def t(a):
    return None if a is None else torch.from_numpy(np.asarray(a, np.float32))


def assert_rel(name, port, ref, tol):
    port, ref = port.detach().numpy(), np.asarray(ref)
    assert port.shape == ref.shape, (name, port.shape, ref.shape)
    err = np.max(np.abs(port - ref))
    assert err <= tol * max(np.max(np.abs(ref)), 1e-30), \
        f"{name}: max abs err {err:.3e}, scale {np.max(np.abs(ref)):.3e}"


def inputs(b, h, w, kernel, conf, seed):
    """pred, row-normalised affinities, conf and sparse depth; a corner of
    zero pred and depth with non-negative affinities, whose pre-clip values
    are exact zeros: the clip's ties."""
    rng = np.random.default_rng(seed)
    k2 = kernel * kernel
    pred = rng.uniform(-1.0, 5.0, (b, h, w)).astype(np.float32)
    aff = rng.standard_normal((b, k2, h, w)).astype(np.float32)
    aff /= np.abs(aff).sum(1, keepdims=True)
    cf = rng.uniform(0.1, 1.0, (b, h, w)).astype(np.float32) if conf else None
    dep = ((rng.random((b, h, w)) > 0.8) * rng.uniform(0.5, 5.0, (b, h, w))
           ).astype(np.float32)
    q = (slice(None), slice(0, max(h // 3, 1)), slice(0, max(w // 3, 1)))
    pred[q] = 0.0
    dep[q] = 0.0
    aff[q[0], :, q[1], q[2]] = np.abs(aff[q[0], :, q[1], q[2]])
    g = rng.standard_normal((b, h, w)).astype(np.float32)
    return pred, aff, cf, dep, g


def jax_loop(pred, aff, cf, dep, **kw):
    return propagate_loop_pallas_planar(
        pred, aff, conf=cf, dep=dep if kw["preserve"] or kw["pre_blend"] else None, **kw)


# b, h, w, kernel, steps, conf, preserve, clip, pre_blend
CASES = [
    (2, 10, 13, 3, 12, True, True, False, False),   # the model's loop
    (1, 9, 11, 3, 4, True, True, True, True),
    (2, 8, 12, 5, 1, False, False, True, False),
    (1, 5, 7, 3, 12, True, False, True, True),      # narrower than the halo
    (1, 6, 9, 5, 4, True, True, False, True),       # halo 8 > 6 rows
]


@pytest.mark.parametrize("b,h,w,kernel,steps,conf,preserve,clip,pre_blend", CASES)
def test_forward_matches_the_tpu_loop_kernel(b, h, w, kernel, steps, conf,
                                             preserve, clip, pre_blend):
    pred, aff, cf, dep, _ = inputs(b, h, w, kernel, conf, seed=h * w + steps)
    kw = dict(steps=steps, kernel=kernel, preserve=preserve, clip=clip,
              pre_blend=pre_blend)
    ref = jax_loop(*map(lambda a: None if a is None else jnp.asarray(a),
                        (pred, aff, cf, dep)), **kw)
    out = prop_loop_plain(t(pred), t(aff), t(cf), t(dep), **kw)
    assert_rel("prop_loop_plain", out, ref, FORWARD_TOL)
    launches = prop_loop.launches
    assert torch.equal(prop_loop(t(pred), t(aff), t(cf), t(dep), **kw), out)
    assert prop_loop.launches == launches      # the CPU runs no kernel
    if preserve:
        m = dep > 0
        assert np.array_equal(out.numpy()[m], dep[m])


@pytest.mark.parametrize("b,h,w,kernel,steps,conf,preserve,clip,pre_blend", [
    CASES[0], CASES[1], CASES[2], CASES[4]])
def test_gradients_match_jax_vjp(b, h, w, kernel, steps, conf, preserve, clip,
                                 pre_blend):
    """(d_pred, d_aff, d_conf) against jax.vjp of the JAX package's
    differentiable loop op, with the clip's exact-zero ties where it is on."""
    pred, aff, cf, dep, g = inputs(b, h, w, kernel, conf, seed=7 * h + steps)
    kw = dict(steps=steps, kernel=kernel, preserve=preserve, clip=clip,
              pre_blend=pre_blend)
    primals = (pred, aff) + ((cf,) if conf else ())

    def f(p, a, *c):
        return jax_loop(p, a, c[0] if c else None, jnp.asarray(dep), **kw)

    out_j, vjp = jax.vjp(f, *map(jnp.asarray, primals))
    ref = vjp(jnp.asarray(g))
    if clip:
        assert np.any(np.asarray(out_j) == 0.0)   # the ties are exercised
    got = prop_loop_bwd_plain(t(g), t(pred), t(aff), t(cf), t(dep), **kw)
    for name, gp, gr in zip(("d_pred", "d_aff", "d_conf"), got, ref):
        assert_rel(name, gp, gr, GRAD_TOL)
    if not conf:
        assert got[2] is None
    # the wrapper's CPU path: autograd through the Function, and the direct
    # backward, are the plain backward's bits
    leaves = [t(a).requires_grad_(True) for a in primals]
    out = prop_loop(leaves[0], leaves[1], leaves[2] if conf else None, t(dep), **kw)
    launches = prop_loop_bwd.launches
    for gp, gd in zip(torch.autograd.grad(out, leaves, t(g)), got):
        assert torch.equal(gp, gd)
    direct = prop_loop_bwd(t(g), t(pred), t(aff), t(cf), t(dep), None, **kw)
    for gp, gd in zip(direct, got):
        assert (gp is None and gd is None) or torch.equal(gp, gd)
    assert prop_loop_bwd.launches == launches


def test_loop_is_steps_of_the_step():
    """prop_loop_plain is `steps` calls of prop_step_plain: the same bits."""
    pred, aff, cf, dep, _ = inputs(2, 11, 14, 3, True, seed=3)
    cur = t(pred)
    for _ in range(5):
        cur = prop_step_plain(cur, t(aff), t(cf), t(dep), kernel=3,
                              preserve=True, clip=True)
    out = prop_loop_plain(t(pred), t(aff), t(cf), t(dep), steps=5, kernel=3,
                          preserve=True, clip=True, pre_blend=False)
    assert torch.equal(out, cur)


@pytest.mark.parametrize("steps,kernel,shape,backward,tile,launches", [
    (12, 3, (12, 228, 304), False, 32, 1),    # the train step's loop: one launch
    (12, 3, (12, 228, 304), True, 32, 1),
    (12, 3, (1, 256, 320), False, 32, 1),     # 54 rows of 14 strips: 768 threads
    (12, 3, (1, 240, 1216), True, 32, 1),
    (12, 5, (4, 256, 320), True, 16, 2),      # 5x5's staged affinities: smaller tiles, split
    (18, 5, (4, 256, 320), False, 32, 9),     # 25 affinities a cell: 2 steps a launch
    (200, 3, (4, 256, 320), False, 32, 17),   # regions past the threads' registers: split
    (12, 13, (4, 256, 320), True, 8, 2),      # 169 sums a pixel: a smaller tile
])
def test_plan_fits_shared_memory(steps, kernel, shape, backward, tile, launches):
    got_tile, chunks = plan(steps, kernel, shape, 132, backward)
    assert (got_tile, len(chunks)) == (tile, launches)
    assert chunks[0][0] == 0 and chunks[-1][1] == steps
    assert all(a[1] == b[0] for a, b in zip(chunks, chunks[1:]))
    r = kernel // 2
    for k0, k1 in chunks:
        side = tile + 2 * (k1 - k0) * r
        floats = _bwd_floats(tile, k1 - k0, kernel, False) if backward else 2 * side * side
        assert floats * 4 <= 232448


def test_prop_loop_checks_its_arguments():
    x, a = torch.zeros(1, 4, 4), torch.zeros(1, 9, 4, 4)
    for kw in ({"preserve": True}, {"pre_blend": True}):
        with pytest.raises(ValueError, match="need dep"):
            prop_loop(x, a, steps=2, **kw)
        with pytest.raises(ValueError, match="need dep"):
            prop_loop_plain(x, a, None, None, steps=2, kernel=3, clip=False,
                            **{"preserve": False, "pre_blend": False, **kw})
    with pytest.raises(ValueError, match="odd"):
        prop_loop(x, torch.zeros(1, 4, 4, 4), steps=2, kernel=2)
    with pytest.raises(ValueError, match="steps"):
        prop_loop(x, a, steps=0)
