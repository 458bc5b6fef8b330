"""K9 ``small_conv3x3_planar`` and its backward K9b held against the JAX
package's TPU kernels, on the CPU.

The port's wrappers, given CPU tensors, run their plain PyTorch versions
(``F.conv2d`` over the concat, and its ``torch.func.vjp``); the JAX side runs
``_fwd_pallas`` and ``_bwd_pallas`` in interpret mode. Inputs come from
seeded numpy generators and go to both sides; the JAX package's NHWC inputs
and HWIO weights are transposed to the port's NCHW and OIHW with numpy. The
CUDA kernels themselves are held against these plain versions on the card
by ``chip_smoke.py``. Relative error is max |port - jax| / max |jax|.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nlspn_eccv20_tpu.ops.pallas.dec_aff_tail as jax_dat
import nlspn_eccv20_tpu.ops.pallas.small_conv3x3 as sc
from nlspn_eccv20_tpu_torch.config import Config
from nlspn_eccv20_tpu_torch.models import get_model
from nlspn_eccv20_tpu_torch.ops.kernels.small_conv3x3 import (
    SmallConv3x3Function, fuse_heads_dec0, small_conv3x3_bwd,
    small_conv3x3_bwd_plain, small_conv3x3_plain, small_conv3x3_planar)
from nlspn_eccv20_tpu_torch.utils.weights import randomize_


@pytest.fixture(autouse=True)
def _interpret(monkeypatch):
    monkeypatch.setattr(sc, "FORCE_PALLAS_INTERPRET", True)
    monkeypatch.setattr(jax_dat, "MATMUL_PRECISION", "highest")


def _inputs(seed, b, h, w, ca, cb, k):
    """NHWC activations and an HWIO weight for the JAX side."""
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, h, w, ca)).astype(np.float32),
            rng.standard_normal((b, h, w, cb)).astype(np.float32),
            (rng.standard_normal((3, 3, ca + cb, k)) * 0.1).astype(np.float32),
            (rng.standard_normal(k) * 0.1).astype(np.float32))


def _port(xa, xb, w, b):
    """The same arrays in the port's layouts: NCHW and OIHW."""
    return (torch.from_numpy(np.ascontiguousarray(xa.transpose(0, 3, 1, 2))),
            torch.from_numpy(np.ascontiguousarray(xb.transpose(0, 3, 1, 2))),
            torch.from_numpy(np.ascontiguousarray(w.transpose(3, 2, 0, 1))),
            torch.from_numpy(b))


def assert_rel(name, port, ref, tol):
    port, ref = port.detach().numpy(), np.asarray(ref)
    assert port.shape == ref.shape, (name, port.shape, ref.shape)
    err = np.max(np.abs(port - ref)) / np.max(np.abs(ref))
    assert err <= tol, f"{name}: relative error {err:.3e} > {tol:.0e}"


@pytest.mark.parametrize("shape", [
    (2, 16, 24, 16, 8, 10),
    (1, 9, 31, 8, 8, 4),       # odd sizes
])
def test_forward_matches_pallas_kernel(shape):
    """1e-5: f32 sums of (Ca + Cb) 9 products in another order."""
    args = _inputs(0, *shape)
    ref = sc._fwd_pallas(*map(jnp.asarray, args))
    assert_rel("reference", torch.from_numpy(np.array(
        sc.small_conv3x3_reference(*map(jnp.asarray, args)))), ref, 1e-5)
    n0 = small_conv3x3_planar.launches
    out = small_conv3x3_planar(*_port(*args))
    assert out.shape == (shape[0], shape[5], shape[1], shape[2])
    assert_rel("out", out, ref, 1e-5)
    assert small_conv3x3_planar.launches == n0  # the CPU runs no kernel


def test_gradients_match_jax_grad():
    """Autograd through ``SmallConv3x3Function`` (on the CPU its backward
    is the plain one) against ``jax.grad`` of the JAX op, whose custom VJP
    runs ``_bwd_pallas`` in interpret mode; 2e-4, the JAX test's bar."""
    shape = (2, 16, 24, 16, 8, 10)
    args = _inputs(1, *shape)
    g = np.random.default_rng(2).standard_normal(
        (shape[0], shape[5], shape[1], shape[2])).astype(np.float32)

    def loss(*a):
        return jnp.vdot(sc.small_conv3x3_planar(*a), jnp.asarray(g))

    ref = jax.jit(jax.grad(loss, argnums=(0, 1, 2, 3)))(*map(jnp.asarray, args))
    leaves = [t.requires_grad_(True) for t in _port(*args)]
    out = small_conv3x3_planar(*leaves)
    assert out.grad_fn is not None and "SmallConv3x3" in type(out.grad_fn).__name__
    grads = torch.autograd.grad(out, leaves, torch.from_numpy(g))
    nchw = (lambda a: np.asarray(a).transpose(0, 3, 1, 2))
    assert_rel("dxa", grads[0], nchw(ref[0]), 2e-4)
    assert_rel("dxb", grads[1], nchw(ref[1]), 2e-4)
    assert_rel("dw", grads[2], np.asarray(ref[2]).transpose(3, 2, 0, 1), 2e-4)
    assert_rel("db", grads[3], ref[3], 2e-4)


def test_plain_backward_matches_pallas_bwd():
    """``small_conv3x3_bwd_plain`` (and the wrapper, which runs it on a CPU
    tensor) against ``_bwd_pallas`` in interpret mode, on an odd shape and
    K = 26, the ``offset`` heads' width. 2e-4 as above."""
    shape = (1, 9, 31, 8, 8, 26)
    args = _inputs(3, *shape)
    g = np.random.default_rng(4).standard_normal(
        (shape[0], shape[5], shape[1], shape[2])).astype(np.float32)
    rdxa, rdxb, rdw, rdb = sc._bwd_pallas(*map(jnp.asarray, args), jnp.asarray(g))
    xa, xb, w, _ = _port(*args)
    got = small_conv3x3_bwd_plain(torch.from_numpy(g), xa, xb, w)
    nchw = (lambda a: np.asarray(a).transpose(0, 3, 1, 2))
    assert_rel("dxa", got[0], nchw(rdxa), 2e-4)
    assert_rel("dxb", got[1], nchw(rdxb), 2e-4)
    assert_rel("dw", got[2], np.asarray(rdw).transpose(3, 2, 0, 1), 2e-4)
    assert_rel("db", got[3], rdb, 2e-4)
    n0 = small_conv3x3_bwd.launches
    for a, b in zip(small_conv3x3_bwd(torch.from_numpy(g), xa, xb, w), got):
        assert torch.equal(a, b)
    assert small_conv3x3_bwd.launches == n0


@pytest.mark.parametrize("offset", [False, True])
def test_fused_heads_equal_the_three_stage2_convs(offset):
    """The heads identity: K9 over the three heads' stage-1 outputs and fe1,
    with ``fuse_heads_dec0``'s weights, equals the three ``*_dec0`` convs
    concatenated (K = 10, or 26 with ``offset``). A narrow model (small GRU)
    at 24x32 on the CPU, every weight random; 1e-5 relative (one f32 conv
    against three, the fused one adding zeros)."""
    cfg = Config(GRU_hidden_dim=16, GRU_input_dim=16, prop_time=2,
                 offset=offset, compile_cache=False)
    model = get_model(cfg, device="cpu").eval()
    randomize_(model, torch.Generator().manual_seed(5))
    seen = {}
    for name, _ in model.head_specs:
        getattr(model, f"{name}_dec0").register_forward_hook(
            lambda mod, inp, out, name=name: seen.__setitem__(name, (inp[0], out)))
    rng = np.random.default_rng(6)
    dep = (rng.random((1, 1, 24, 32)) > 0.9) * rng.uniform(0.5, 5.0, (1, 1, 24, 32))
    with torch.inference_mode():
        model({"rgb": torch.from_numpy(rng.standard_normal((1, 3, 24, 32)).astype(np.float32)),
               "dep": torch.from_numpy(dep.astype(np.float32))})
        width = model.HEAD_WIDTH
        names = [n for n, _ in model.head_specs]
        xa = torch.cat([seen[n][0][:, :width] for n in names], 1)
        xb = seen[names[0]][0][:, width:]
        w, b = fuse_heads_dec0([(getattr(model, f"{n}_dec0")[0].weight,
                                 getattr(model, f"{n}_dec0")[0].bias) for n in names],
                               width)
        out = small_conv3x3_planar(xa, xb, w, b)
    ref = torch.cat([seen[n][1] for n in names], 1)
    assert w.shape == (10 if not offset else 26, 3 * width + 64, 3, 3)
    assert out.shape == ref.shape
    assert_rel("heads", out, ref.numpy(), 1e-5)


def test_bf16_and_bad_shapes_raise():
    xa, xb, w, b = _port(*_inputs(7, 1, 4, 5, 3, 2, 4))
    with pytest.raises(NotImplementedError, match="bf16"):
        small_conv3x3_planar(xa.bfloat16(), xb.bfloat16(), w.bfloat16(), b.bfloat16())
    with pytest.raises(ValueError, match="K = 33"):
        small_conv3x3_planar(xa, xb, torch.zeros(33, 5, 3, 3), torch.zeros(33))
    with pytest.raises(ValueError):
        small_conv3x3_planar(xa, xb[:, :, :3], w, b)
    # equal to the plain version, the Function included
    assert torch.equal(SmallConv3x3Function.apply(xa, xb, w, b),
                       small_conv3x3_plain(xa, xb, w, b))
