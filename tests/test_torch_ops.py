"""The PyTorch port's ops and kernel wrappers held against the JAX package,
on the CPU.

Each kernel wrapper, given CPU tensors, runs its plain PyTorch version; the
JAX side runs its Pallas kernel in interpret mode (or its plain reference
where the Pallas kernel does not take the shape). Inputs come from seeded
numpy generators and go to both sides; weights are converted between the
JAX package's layouts and torch's by the weight bridge's own helpers.
The CUDA kernels themselves are held against these plain versions on the
card by ``chip_smoke.py``.

The backward kernels' plain versions (what each autograd Function's
backward runs on a CPU tensor) are held against the JAX package's VJPs:
its custom VJP of the Pallas stencil for K1b, and its Pallas backward
kernels in interpret mode for K4 and K5. Relative error here is
max |port - jax| / max |jax| per gradient.
"""

import ctypes

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nlspn_eccv20_tpu.ops.pallas.dec_aff_tail as jax_dat
import nlspn_eccv20_tpu.ops.pallas.dep_encode_front as jax_def
from nlspn_eccv20_tpu.ops.affinity import normalize_affinity_planar as jax_norm
from nlspn_eccv20_tpu.ops.pallas.local_prop import fused_prop_step_planar
from nlspn_eccv20_tpu.ops.planar import planar_channel_mlp as jax_mlp
from nlspn_eccv20_tpu_torch.ops.affinity import normalize_affinity
from nlspn_eccv20_tpu_torch.ops.kernels import build
from nlspn_eccv20_tpu_torch.ops.kernels.dec_aff_tail import (
    decode_aff_tail, decode_aff_tail_bwd, decode_aff_tail_bwd_plain)
from nlspn_eccv20_tpu_torch.ops.kernels.dep_encode_front import (
    dep_encode_front, dep_encode_front_bwd, dep_encode_front_bwd_plain)
from nlspn_eccv20_tpu_torch.ops.kernels.prop_step import (
    prop_step, prop_step_bwd, prop_step_bwd_plain)
from nlspn_eccv20_tpu_torch.ops.planar import planar_channel_mlp
from nlspn_eccv20_tpu_torch.utils.weights import _conv_w, _convt_w


def t(a):
    return torch.from_numpy(np.asarray(a, np.float32))


def close(port, ref, tol):
    np.testing.assert_allclose(port.numpy(), np.asarray(ref), rtol=tol, atol=tol)


def assert_rel(name, port, ref, tol):
    """max |port - ref| / max |ref| <= tol (ref non-zero)."""
    port, ref = port.detach().numpy(), np.asarray(ref)
    assert port.shape == ref.shape, (name, port.shape, ref.shape)
    scale = np.max(np.abs(ref))
    assert scale > 0, name
    err = np.max(np.abs(port - ref))
    assert err / scale <= tol, f"{name}: max abs err {err:.3e}, scale {scale:.3e}"


def leaf(a):
    return t(a).requires_grad_(True)


def _convt_w_inv(w):
    """Inverse of the weight bridge's ConvTranspose conversion: torch
    (in, out, kh, kw) -> the JAX package's pre-flipped HWIO."""
    return np.flip(np.transpose(w.detach().numpy(), (2, 3, 0, 1)), (0, 1))


def _conv_w_inv(w):
    """torch OIHW -> HWIO."""
    return np.transpose(w.detach().numpy(), (2, 3, 1, 0))


# ---- K1: prop_step ------------------------------------------------------

@pytest.mark.parametrize("kernel", [3, 5])
@pytest.mark.parametrize("conf,preserve,clip", [
    (True, True, False),      # fork default
    (False, False, False),
    (True, False, True),
    (False, True, True),
])
def test_prop_step_matches_pallas_step(kernel, conf, preserve, clip):
    rng = np.random.default_rng(kernel)
    b, h, w, k2 = 2, 13, 19, kernel * kernel
    pred = rng.uniform(-1.0, 5.0, (b, h, w)).astype(np.float32)
    aff = rng.standard_normal((b, k2, h, w)).astype(np.float32) / k2
    cf = rng.uniform(0.0, 1.0, (b, h, w)).astype(np.float32)
    dep = ((rng.random((b, h, w)) > 0.8) * rng.uniform(0.5, 5.0, (b, h, w))
           ).astype(np.float32)
    ref = fused_prop_step_planar(
        jnp.asarray(pred), jnp.asarray(aff),
        conf=jnp.asarray(cf) if conf else None,
        dep=jnp.asarray(dep) if preserve else None,
        kernel=kernel, preserve=preserve, clip=clip)
    launches = prop_step.launches
    out = prop_step(t(pred), t(aff), t(cf) if conf else None,
                    t(dep) if preserve else None, kernel=kernel,
                    preserve=preserve, clip=clip)
    close(out, ref, 1e-6)
    assert prop_step.launches == launches  # the CPU runs no kernel
    if preserve:
        m = dep > 0
        assert np.array_equal(out.numpy()[m], dep[m])


@pytest.mark.parametrize("kernel", [3, 5])
@pytest.mark.parametrize("conf,preserve,clip", [
    (True, True, False),      # fork default
    (False, False, False),
    (True, False, True),
    (False, True, True),
])
def test_prop_step_gradients_match_jax_vjp(kernel, conf, preserve, clip):
    """K1b's plain version against jax.vjp through the step, whose stencil
    is the Pallas kernel with its custom VJP (local_prop._stencil). A zero
    corner of pred gives exact zeros before the clip: ties, where both
    sides pass half the gradient."""
    rng = np.random.default_rng(10 + kernel)
    b, h, w, k2 = 2, 11, 17, kernel * kernel
    pred = rng.uniform(-1.0, 5.0, (b, h, w)).astype(np.float32)
    pred[:, :5, :7] = 0.0
    aff = (rng.standard_normal((b, k2, h, w)) / k2).astype(np.float32)
    cf = rng.uniform(0.1, 1.0, (b, h, w)).astype(np.float32)
    dep = ((rng.random((b, h, w)) > 0.8) * rng.uniform(0.5, 5.0, (b, h, w))
           ).astype(np.float32)
    g = rng.standard_normal((b, h, w)).astype(np.float32)

    def jax_step(p, a, *c):
        return fused_prop_step_planar(
            p, a, conf=c[0] if conf else None,
            dep=jnp.asarray(dep) if preserve else None,
            kernel=kernel, preserve=preserve, clip=clip)

    primals = (pred, aff) + ((cf,) if conf else ())
    out_j, vjp = jax.vjp(jax_step, *map(jnp.asarray, primals))
    ref = vjp(jnp.asarray(g))
    if clip:
        assert np.any(np.asarray(out_j) == 0.0)  # the ties are exercised

    leaves = [leaf(a) for a in primals]
    out = prop_step(leaves[0], leaves[1], leaves[2] if conf else None,
                    t(dep) if preserve else None, kernel=kernel,
                    preserve=preserve, clip=clip)
    grads = torch.autograd.grad(out, leaves, t(g))
    for name, gp, gr in zip(("pred", "aff", "conf"), grads, ref):
        assert_rel(f"d_{name}", gp, gr, 1e-5)
    # the wrapper's CPU path is the plain backward
    direct = prop_step_bwd(t(g), *map(t, primals[:2]), t(cf) if conf else None,
                           t(dep) if preserve else None, kernel=kernel,
                           preserve=preserve, clip=clip)
    for gp, gd in zip(grads, direct):
        assert torch.equal(gp, gd)


def test_prop_step_clip_tie_passes_half():
    """All-zero neighbourhood -> out == 0 exactly -> half the gradient,
    as jnp.maximum passes; torch.clamp would pass all of it."""
    pred = torch.zeros(1, 3, 3, requires_grad=True)
    aff = torch.full((1, 9, 3, 3), 1.0 / 9, requires_grad=True)
    out = prop_step(pred, aff, kernel=3, clip=True)
    (d_aff,) = torch.autograd.grad(out.sum(), [aff])
    assert torch.equal(d_aff, torch.zeros_like(d_aff))
    d_pred, _, _ = prop_step_bwd_plain(torch.ones(1, 3, 3), pred.detach(),
                                       aff.detach(), None, None, kernel=3,
                                       preserve=False, clip=True)
    assert torch.allclose(d_pred.sum(), torch.tensor(0.5 * 9))


def test_prop_step_needs_dep_to_preserve():
    x = torch.zeros(1, 4, 4)
    with pytest.raises(ValueError):
        prop_step(x, torch.zeros(1, 9, 4, 4), preserve=True)


# ---- K2: decode_aff_tail ------------------------------------------------

@pytest.fixture
def highest_precision(monkeypatch):
    monkeypatch.setattr(jax_dat, "MATMUL_PRECISION", "highest")
    monkeypatch.setattr(jax_dat, "FORCE_PALLAS_INTERPRET", True)


@pytest.mark.parametrize("b,hg,wg,c,m,k", [
    (2, 6, 10, 16, 16, 8),
    (1, 5, 9, 8, 16, 24),      # odd sizes, prop_kernel 5
    (1, 4, 130, 8, 16, 8),     # wide: the TPU kernel tiles it
])
def test_decode_aff_tail_matches_pallas(highest_precision, b, hg, wg, c, m, k):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((b, hg, wg, c)).astype(np.float32)
    w1 = (rng.standard_normal((3, 3, c, m)) * 0.1).astype(np.float32)
    b1 = (rng.standard_normal(m) * 0.1).astype(np.float32)
    w2 = (rng.standard_normal((3, 3, m, k)) * 0.2).astype(np.float32)
    b2 = (rng.standard_normal(k) * 0.1).astype(np.float32)
    ref = jax_dat._fwd_pallas(*map(jnp.asarray, (x, w1, b1, w2, b2)))
    out = decode_aff_tail(t(x), _convt_w(w1), t(b1), _convt_w(w2), t(b2))
    assert out.shape == (b, k, 4 * hg, 4 * wg) and out.is_contiguous()
    close(out, ref, 1e-5)


@pytest.mark.parametrize("b,hg,wg,c,k", [
    (2, 5, 7, 16, 8),
    (1, 4, 6, 8, 24),          # prop_kernel 5
])
def test_decode_aff_tail_gradients_match_pallas_bwd(highest_precision, b, hg,
                                                    wg, c, k):
    """K4's plain version against the TPU backward kernel (_bwd_pallas, in
    interpret mode), all five gradients. 1e-4: f32 sums of up to 2,304
    products in another order. The bottom rows of g are zero, as the
    model's trim of the deconv over-padding makes them."""
    rng = np.random.default_rng(4)
    x = np.maximum(rng.standard_normal((b, hg, wg, c)), 0).astype(np.float32)
    w1 = (rng.standard_normal((3, 3, c, 16)) * 0.2).astype(np.float32)
    b1 = (rng.standard_normal(16) * 0.1).astype(np.float32)
    w2 = (rng.standard_normal((3, 3, 16, k)) * 0.2).astype(np.float32)
    b2 = (rng.standard_normal(k) * 0.1).astype(np.float32)
    g = rng.standard_normal((b, k, 4 * hg, 4 * wg)).astype(np.float32)
    g[:, :, -4:] = 0.0
    _, vjp = jax.vjp(jax_dat.decode_aff_tail,
                     *map(jnp.asarray, (x, w1, b1, w2, b2)))
    rx, rw1, rb1, rw2, rb2 = vjp(jnp.asarray(g))

    leaves = [leaf(x), _convt_w(w1).requires_grad_(True), leaf(b1),
              _convt_w(w2).requires_grad_(True), leaf(b2)]
    out = decode_aff_tail(*leaves)
    dx, dw1, db1, dw2, db2 = torch.autograd.grad(out, leaves, t(g))
    assert_rel("dx", dx, rx, 1e-4)
    assert_rel("dw1", torch.from_numpy(_convt_w_inv(dw1).copy()), rw1, 1e-4)
    assert_rel("db1", db1, rb1, 1e-4)
    assert_rel("dw2", torch.from_numpy(_convt_w_inv(dw2).copy()), rw2, 1e-4)
    assert_rel("db2", db2, rb2, 1e-4)


# ---- K3: dep_encode_front -----------------------------------------------

def _front_inputs(rng, b, h, w, m, c1):
    return (rng.standard_normal((b, h, w)).astype(np.float32),
            (rng.standard_normal((3, 3, 1, m)) * 0.3).astype(np.float32),
            (rng.standard_normal(m) * 0.1).astype(np.float32),
            (rng.standard_normal((3, 3, m, c1)) * 0.1).astype(np.float32),
            (rng.standard_normal(c1) * 0.1).astype(np.float32))


def _port_front(x, w0, b0, w1, b1):
    return dep_encode_front(t(x), _conv_w(w0), t(b0), _conv_w(w1), t(b1))


@pytest.mark.parametrize("shape", [(2, 24, 40, 16, 32), (1, 16, 24, 16, 8)])
def test_dep_encode_front_matches_pallas(monkeypatch, shape):
    monkeypatch.setattr(jax_def, "FORCE_PALLAS_INTERPRET", True)
    args = _front_inputs(np.random.default_rng(1), *shape)
    ref = jax_def._fwd_pallas(*map(jnp.asarray, args), jnp.float32)
    out = _port_front(*args)
    assert out.shape == ref.shape and out.is_contiguous()
    close(out, ref, 1e-5)


def test_dep_encode_front_matches_reference_unaligned():
    """H, W not multiples of 4: the TPU kernel refuses them, the port's
    kernel takes them; held against the JAX plain reference."""
    args = _front_inputs(np.random.default_rng(2), 2, 30, 42, 16, 32)
    ref = jax_def.dep_encode_front_reference(*map(jnp.asarray, args))
    out = _port_front(*args)
    assert out.shape == (2, 8, 11, 32) == ref.shape
    close(out, ref, 1e-5)


@pytest.mark.parametrize("shape", [(2, 16, 24, 16, 32), (1, 12, 20, 16, 8)])
def test_dep_encode_front_gradients_match_pallas_bwd(monkeypatch, shape):
    """K5's plain version against the TPU backward kernel (_bwd_pallas, in
    interpret mode), all five gradients; dx is the gradient into the depth
    plane that flows back into pred. 1e-4: f32 sums in another order."""
    monkeypatch.setattr(jax_def, "FORCE_PALLAS_INTERPRET", True)
    args = _front_inputs(np.random.default_rng(5), *shape)
    out_j, vjp = jax.vjp(jax_def.dep_encode_front, *map(jnp.asarray, args))
    g = np.random.default_rng(6).standard_normal(out_j.shape).astype(np.float32)
    rx, rw0, rb0, rw1, rb1 = vjp(jnp.asarray(g))

    x, w0, b0, w1, b1 = args
    leaves = [leaf(x), _conv_w(w0).requires_grad_(True), leaf(b0),
              _conv_w(w1).requires_grad_(True), leaf(b1)]
    out = dep_encode_front(*leaves)
    dx, dw0, db0, dw1, db1 = torch.autograd.grad(out, leaves, t(g))
    assert_rel("dx", dx, rx, 1e-4)
    assert_rel("dw0", torch.from_numpy(_conv_w_inv(dw0).copy()), rw0, 1e-4)
    assert_rel("db0", db0, rb0, 1e-4)
    assert_rel("dw1", torch.from_numpy(_conv_w_inv(dw1).copy()), rw1, 1e-4)
    assert_rel("db1", db1, rb1, 1e-4)


def test_backward_wrappers_run_plain_versions_on_cpu():
    """On a CPU tensor each backward wrapper returns its plain version's
    gradients (on a CUDA tensor it launches its kernel or raises)."""
    rng = np.random.default_rng(9)
    x = t(np.maximum(rng.standard_normal((1, 2, 3, 16)), 0))
    w1, w2 = t(rng.standard_normal((16, 16, 3, 3))), t(rng.standard_normal((16, 8, 3, 3)))
    y1, g = t(rng.uniform(-1, 1, (1, 16, 4, 6))), torch.ones(1, 8, 8, 12)
    got = decode_aff_tail_bwd(g, x, w1, w2, y1)
    for a, b in zip(got, decode_aff_tail_bwd_plain(g, x, w1, w2, y1)):
        assert torch.equal(a, b)
    assert torch.all(got[4] == 96.0)  # db2 = sum of g over 8 x 12 pixels
    plane, w0, b0 = torch.zeros(1, 8, 8), t(rng.standard_normal((16, 1, 3, 3))), torch.ones(16)
    w1, out, g = t(rng.standard_normal((8, 16, 3, 3))), torch.ones(1, 2, 2, 8), torch.ones(1, 2, 2, 8)
    got = dep_encode_front_bwd(g, plane, w0, b0, w1, out)
    for a, b in zip(got, dep_encode_front_bwd_plain(g, plane, w0, b0, w1, out)):
        assert torch.equal(a, b)
    assert torch.all(got[4] == 4.0)  # db1: every output is 1 > 0


# ---- affinity normalization and the S2D channel MLP ---------------------

@pytest.mark.parametrize("mode", ["AS", "ASS", "TC", "TGASS"])
@pytest.mark.parametrize("n", [8, 24])
def test_normalize_affinity_matches_jax(mode, n):
    rng = np.random.default_rng(n)
    raw = (rng.standard_normal((2, n, 7, 9)) * 2).astype(np.float32)
    gamma = np.asarray([0.5 * n], np.float32)
    ref = jax_norm(jnp.asarray(raw), jnp.asarray(gamma), mode)
    out = normalize_affinity(t(raw), t(gamma), mode)
    assert out.shape == (2, n + 1, 7, 9)
    close(out, ref, 1e-6)


def test_normalize_affinity_rejects_unknown_mode():
    with pytest.raises(NotImplementedError):
        normalize_affinity(torch.zeros(1, 8, 2, 2), torch.ones(1), "XX")


def test_planar_channel_mlp_matches_jax():
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 6, 11, 13)).astype(np.float32)
    w0 = rng.standard_normal((6, 8)).astype(np.float32) * 0.4
    b0 = rng.standard_normal(8).astype(np.float32) * 0.1
    w1 = rng.standard_normal((8, 16)).astype(np.float32) * 0.35
    b1 = rng.standard_normal(16).astype(np.float32) * 0.1
    ref = jax_mlp(*map(jnp.asarray, (x, w0, b0, w1, b1)))
    close(planar_channel_mlp(*map(t, (x, w0, b0, w1, b1))), ref, 1e-6)


# ---- the build helper (no nvcc here: only what it would run) -------------

def test_every_source_builds_for_sm_90a_into_build():
    names = build.kernel_names()
    assert names == ["dec_aff_tail", "dec_aff_tail_bwd", "deform_colgather",
                     "deform_prop", "deform_prop_bwd", "deform_windowed",
                     "dep_encode_front", "dep_encode_front_bwd",
                     "gather_probe", "interleave_asm", "interleave_onehot",
                     "interleave_strided", "prop_loop", "prop_loop_bwd",
                     "prop_step", "prop_step_bwd", "small_conv3x3",
                     "small_conv3x3_bwd", "tile_repeat_probe"]
    cmd = " ".join(build.NVCC_FLAGS)
    assert "-gencode arch=compute_90a,code=sm_90a" in cmd
    assert "-shared" in cmd and "-fPIC" in cmd and "-O3" in cmd
    for name in names:
        path = build.library_path(name)
        assert path.startswith(build.BUILD_DIR) and path.endswith(".so")
        assert f"lib{name}-" in path


def test_wrappers_declare_pointers_as_void_p():
    """ctypes would cut a pointer or the stream passed as a default int."""
    from nlspn_eccv20_tpu_torch.devtools import (exp_deform2, exp_deform3,
                                                  exp_deform_prop_kernel,
                                                  microbench_asm,
                                                  microbench_interleave)
    from nlspn_eccv20_tpu_torch.ops.kernels import (dec_aff_tail,
                                                     deform_prop,
                                                     dep_encode_front,
                                                     prop_loop, prop_step,
                                                     small_conv3x3)
    for mod in (prop_step, dec_aff_tail, dep_encode_front, deform_prop,
                prop_loop, small_conv3x3, exp_deform_prop_kernel,
                exp_deform3, exp_deform2, microbench_interleave,
                microbench_asm):
        for sigs in (mod._SIGNATURES, getattr(mod, "_BWD_SIGNATURES", {})):
            for sig in sigs.values():
                argtypes = sig[0] if isinstance(sig, tuple) else sig
                if not isinstance(sig, tuple):          # a kernel launch
                    assert argtypes[-1] is ctypes.c_void_p  # the stream
                assert set(argtypes) <= {ctypes.c_void_p, ctypes.c_int}


def test_check_tensor_rejects_cpu_tensors():
    with pytest.raises(ValueError):
        build.check_tensor(torch.zeros(2), "x")
