"""bf16 training (``precision='bf16'``) in the port, held against the JAX
package on the CPU.

K4-bf16's and K5-bf16's plain versions (``decode_aff_tail_bwd_plain_bf16``,
``dep_encode_front_bwd_plain_bf16``), which the card holds the kernels
against, are held against the JAX TPU backwards (``_bwd_pallas`` at
``dt = bfloat16`` in interpret mode) on the same numpy-seeded inputs, each
output at its own bar: the bf16 input gradient dx within one bf16 ulp of
max |ref| (2^-7 of it) with at most 2% of its elements not bit-equal, and
every f32 weight and bias gradient within 5e-4 of max |ref|. Both round at
the same points (the cotangent, the weights, the intermediate gradient and
dx, each once after an f32 sum); only the order of the f32 sums differs,
and a rounding that lands on the other side of a bf16 tie in the
intermediate moves the sums after it by its ulp (measured: dx 0.89% of its
elements at K = 24, the weights at most 2.7e-4). The bars catch a plain
version that leaves out any one rounding point (g, dY1 or the weights in
K4; p0, dP0 or the weights in K5): leaving one out puts 41% to 58% of dx's
elements off (p0 none) and moves some weight or bias gradient by 9e-4 to
1.7e-2 of max |ref| (p0: dw1 by 1.6e-3 to 2.5e-3). They are also held
against the JAX CPU route, the VJP of ``*_reference``, which rounds every
conv's output, adds the biases in bf16 (so its ReLU masks differ) and
rounds its weights' cotangents to bf16: there the JAX package's own two
routes lie up to 0.1 apart (relative L2, K5's db0), and the port must lie
no farther from the CPU route than the TPU kernel does, plus one bf16 ulp.

Train-mode BatchNorm on bf16 is held against Flax's forward and backward.
Flax rounds the cotangents of its two uses of x (the normalisation and the
statistics) to bf16 apart and adds them in bf16, where the library's fused
backward rounds once: a third of dx's elements differ by an ulp.

One bf16 train step of the port is held against the JAX bf16 train step
with both fused kernels in interpret mode, from the same weights (every JAX
variable seeded, carried by ``from_jax_variables``): loss within 1e-2
relative, every parameter's gradient f32 and finite, the BatchNorm running
statistics within 1e-2 (max |d| / max |ref|), each parameter's gradient
within 3/4 to 4/3 of the JAX one's norm, and within 5e-2 of it in relative
L2 distance, or, where bf16 itself moves that gradient farther, within
twice the distance between the JAX bf16 gradient and the f32 one at the
same weights (the port's f32 gradient stands for JAX's:
``tests/test_torch_train.py`` holds the two within 5e-3), never past 0.5.
That distance is large at these seeded weights (0.1 to 0.4 on encoder and
decoder tensors, 1.39 on S2D's 1x1 bias on the loop route) because the
gradient moves with the forward's ReLU masks: BatchNorm centres each
channel, so many pre-activations lie next to 0, and a bf16 forward flips
some of the masks that the f32 one takes. The f32 step moves its gradients
that far too when only its rgb input moves by 2^-9 relative, and with the
unperturbed run's masks frozen most of that goes
(``test_bf16_gradient_gap_is_the_forwards_relu_masks``); a port whose
BatchNorm rounds as Flax's does lies no nearer the JAX step (printed). The
default and offset configurations' steps are in
``tests/test_torch_bf16_train_default.py`` and ``..._offset.py``, each file
under a minute on one worker; the constant-affinity one is here.
"""

import collections
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from torch import nn

import nlspn_eccv20_tpu.ops.pallas.dec_aff_tail as jax_dat
import nlspn_eccv20_tpu.ops.pallas.dep_encode_front as jax_def
from nlspn_eccv20_tpu.losses import get_loss as jax_get_loss
from nlspn_eccv20_tpu.models.common import BatchNorm as JaxBatchNorm
from nlspn_eccv20_tpu_torch.config import Config
from nlspn_eccv20_tpu_torch.losses import LossFunction
from nlspn_eccv20_tpu_torch.models import get_model
from nlspn_eccv20_tpu_torch.models.common import BatchNorm
from nlspn_eccv20_tpu_torch.ops.kernels import dec_aff_tail as dat
from nlspn_eccv20_tpu_torch.ops.kernels import dep_encode_front as dfr
from nlspn_eccv20_tpu_torch.ops.kernels.dec_aff_tail import (
    DecodeAffTailFunction, decode_aff_tail_bwd, decode_aff_tail_bwd_plain_bf16,
    decode_aff_tail_plain_bf16_y1)
from nlspn_eccv20_tpu_torch.ops.kernels.dep_encode_front import (
    dep_encode_front_bwd, dep_encode_front_bwd_plain_bf16, dep_encode_front_plain_bf16)
from nlspn_eccv20_tpu_torch.utils.weights import _conv_w, _convt_w, from_jax_variables
from test_torch_bf16 import H, W, _front_inputs, _tail_inputs, bf16_values, jax_bf16_model, t
from test_torch_model import nchw
from test_torch_train import grads_as_jax_tree, norm_rel_err, rel_err, to_port, train_batch

ULP = 2.0 ** -7                     # one bf16 ulp, relative to max |ref|
SHARE_TOL = 2e-2                    # share of a bf16 output's elements not bit-equal
WGRAD_TOL = 5e-4                    # an f32 weight or bias gradient, of max |ref|
LOSS_TOL, GRAD_TOL, GRAD_CAP, BN_TOL = 1e-2, 5e-2, 0.5, 1e-2
NORM_RATIO = 4 / 3                  # a gradient's norm against the JAX one's, either way


def rel_to_max(port, ref):
    port = np.asarray(port.float() if isinstance(port, torch.Tensor) else port, np.float32)
    ref = np.asarray(ref, np.float32)
    assert port.shape == ref.shape
    return float(np.max(np.abs(port - ref)) / max(np.max(np.abs(ref)), 1e-30))


def assert_grads(what, names, port, ref):
    """The bf16 input gradient (first) within one bf16 ulp of max |ref|
    with at most ``SHARE_TOL`` of its elements not bit-equal; the f32
    weight and bias gradients within ``WGRAD_TOL`` of max |ref|."""
    errs = [rel_to_max(p, r) for p, r in zip(port, ref)]
    share = float(np.mean(np.asarray(port[0].float()) != np.asarray(ref[0], np.float32)))
    print(what, " ".join(f"{n} {e:.2e}" for n, e in zip(names, errs)),
          f"({share:.2e} of {names[0]} not bit-equal)")
    assert errs[0] <= ULP, f"{what} {names[0]}: {errs[0]:.3e} > {ULP:.3e} of max |ref|"
    assert share <= SHARE_TOL, f"{what} {names[0]}: {share:.3e} of it not bit-equal"
    for n, e in zip(names[1:], errs[1:]):
        assert e <= WGRAD_TOL, f"{what} {n}: {e:.3e} > {WGRAD_TOL:.0e} of max |ref|"


def assert_as_close_as_the_tpu_kernel(names, port, tpu, cpu):
    """The port no farther (relative L2) from the JAX CPU route ``cpu`` than
    the TPU kernel's result ``tpu`` is, plus one bf16 ulp."""
    port = [np.asarray(p.float()) for p in port]
    ours = [norm_rel_err(p, c) for p, c in zip(port, cpu)]
    theirs = [norm_rel_err(p, c) for p, c in zip(tpu, cpu)]
    print("vs reference VJP (relative L2, port / TPU kernel):",
          " ".join(f"{n} {a:.2e} / {b:.2e}" for n, a, b in zip(names, ours, theirs)))
    for n, a, b in zip(names, ours, theirs):
        assert a <= b + ULP, f"{n}: {a:.3e} from the CPU route, the TPU kernel {b:.3e}"


# ---- K4-bf16: the plain version against the TPU backward ----

def _tail_case(b, hg, wg, c, k, seed):
    """Numpy inputs of both sides, the port's arguments of
    ``decode_aff_tail_bwd`` (y1 from K2-bf16's plain forward) and the JAX
    ``_bwd_pallas`` arguments (bf16 x, the bf16 cotangent)."""
    x, w1, b1, w2, b2 = _tail_inputs(b, hg, wg, c, k, seed=seed)
    g = np.random.default_rng(seed + 1).standard_normal((b, k, 4 * hg, 4 * wg))
    g = g.astype(np.float32)
    xb = torch.from_numpy(x).bfloat16()
    _, y1 = decode_aff_tail_plain_bf16_y1(xb, _convt_w(w1), t(b1), _convt_w(w2), t(b2))
    port_args = (t(g), xb, _convt_w(w1), _convt_w(w2), y1)
    jax_args = (jnp.asarray(x, jnp.bfloat16), *map(jnp.asarray, (w1, b1, w2, b2)),
                jnp.asarray(g, jnp.bfloat16))
    return port_args, jax_args


def _tail_grads_as_port(dx, dw1, db1, dw2, db2):
    return (np.asarray(jnp.asarray(dx, jnp.float32)), _convt_w(dw1).numpy(),
            np.asarray(db1), _convt_w(dw2).numpy(), np.asarray(db2))


TAIL_NAMES = ("dx", "dw1", "db1", "dw2", "db2")


@pytest.mark.parametrize("b,hg,wg,c,k,seed", [
    (1, 5, 9, 20, 24, 30),     # an odd grid, K = 24, C not in whole channel stages
    (2, 4, 6, 32, 8, 31),      # the model's K = 8, two images
])
def test_decode_aff_tail_bwd_plain_bf16_matches_the_tpu_kernel(monkeypatch, b, hg, wg, c,
                                                               k, seed):
    monkeypatch.setattr(jax_dat, "FORCE_PALLAS_INTERPRET", True)
    port_args, jax_args = _tail_case(b, hg, wg, c, k, seed)
    out = decode_aff_tail_bwd_plain_bf16(*port_args)
    assert out[0].dtype == torch.bfloat16
    assert all(o.dtype == torch.float32 for o in out[1:])
    ref = jax.jit(jax_dat._bwd_pallas)(*jax_args)
    assert ref[0].dtype == jnp.bfloat16
    ref = _tail_grads_as_port(*ref)
    assert_grads("vs _bwd_pallas:", TAIL_NAMES, out, ref)
    # the JAX CPU route: the VJP of the reference composition
    _, vjp = jax.vjp(jax_dat.decode_aff_tail_reference, *jax_args[:5])
    assert_as_close_as_the_tpu_kernel(TAIL_NAMES, out, ref,
                                      _tail_grads_as_port(*vjp(jax_args[5])))
    # the wrapper takes a bf16 x to K4-bf16 (its plain version on the CPU)
    got = decode_aff_tail_bwd(*port_args)
    assert all(torch.equal(a, o) for a, o in zip(got, out))


def test_rounded_y1_gives_the_tpu_kernels_mask():
    """K4-bf16 masks dY1 with [y1 > 0] on y1 rounded to bf16; the TPU kernel
    with [P > 0] on the f32 P. They agree wherever P is not in (0, 2^-134]:
    at the test shapes everywhere, and a P of 2^-140 (a product below
    2^-117) is the case where they part."""
    x, w1, b1, *_ = _tail_inputs(2, 5, 9, 20, 24, seed=30)
    xb, w1r, b1r = (torch.from_numpy(a).bfloat16().float() for a in (x, w1, b1))
    p = torch.nn.functional.conv_transpose2d(xb.permute(0, 3, 1, 2), _convt_w(w1r.numpy()),
                                             b1r, 2, 1, 1)
    y1 = p.relu().bfloat16().float()
    assert torch.equal(y1 > 0, p > 0)
    tiny = torch.tensor([2.0 ** -140])
    assert tiny > 0 and tiny.bfloat16().float() == 0


# ---- K5-bf16: the plain version against the TPU backward ----

def _front_case(b, h, w, c1, seed):
    x, w0, b0, w1, b1 = _front_inputs(b, h, w, c1, seed=seed)
    xb = torch.from_numpy(x).bfloat16()
    out = dep_encode_front_plain_bf16(xb, _conv_w(w0), t(b0), _conv_w(w1), t(b1))
    g = np.random.default_rng(seed + 1).standard_normal(out.shape)
    g = bf16_values(g.astype(np.float32))
    port_args = (torch.from_numpy(g).bfloat16(), xb, _conv_w(w0), t(b0), _conv_w(w1), out)
    jax_args = (*map(jnp.asarray, (x, w0, b0, w1, b1)), jnp.bfloat16,
                jnp.asarray(g, jnp.bfloat16))
    return port_args, jax_args


def _front_grads_as_port(dx, dw0, db0, dw1, db1):
    return (np.asarray(jnp.asarray(dx, jnp.float32)), _conv_w(dw0).numpy(),
            np.asarray(db0), _conv_w(dw1).numpy(), np.asarray(db1))


FRONT_NAMES = ("dx", "dw0", "db0", "dw1", "db1")


@pytest.mark.parametrize("b,h,w,c1,seed", [
    (2, 16, 44, 96, 40),       # Wo = 11 and C1 = 96: one and a half 64-channel groups
    (1, 12, 20, 32, 41),       # an odd quarter grid (3 x 5)
])
def test_dep_encode_front_bwd_plain_bf16_matches_the_tpu_kernel(monkeypatch, b, h, w, c1,
                                                                seed):
    monkeypatch.setattr(jax_def, "FORCE_PALLAS_INTERPRET", True)
    port_args, jax_args = _front_case(b, h, w, c1, seed)
    out = dep_encode_front_bwd_plain_bf16(*port_args)
    assert out[0].dtype == torch.bfloat16
    assert all(o.dtype == torch.float32 for o in out[1:])
    ref = jax.jit(jax_def._bwd_pallas, static_argnums=5)(*jax_args)
    assert ref[0].dtype == jnp.float32        # the plane's gradient stays f32 there
    assert np.array_equal(bf16_values(ref[0]), np.asarray(ref[0]))
    ref = _front_grads_as_port(*ref)
    assert_grads("vs _bwd_pallas:", FRONT_NAMES, out, ref)
    dt, g = jax_args[5], jax_args[6]
    _, vjp = jax.vjp(lambda xp, *a: jax_def.dep_encode_front_reference(xp.astype(dt), *a),
                     *jax_args[:5])
    assert_as_close_as_the_tpu_kernel(FRONT_NAMES, out, ref, _front_grads_as_port(*vjp(g)))
    got = dep_encode_front_bwd(*port_args)
    assert all(torch.equal(a, o) for a, o in zip(got, out))


# ---- the bars tell a plain version that leaves out one rounding point ----

def _keep(a):
    return a


def _tail_bwd_rounding(g, x, w1, w2, y1, skip=""):
    """``decode_aff_tail_bwd_plain_bf16`` written out, leaving out the
    rounding of ``skip`` ("g", "dY1" or "w")."""
    r = {k: _keep if k == skip else dat._bf16 for k in ("g", "dY1", "w")}
    g = r["g"](g)
    _, vjp2 = torch.func.vjp(dat._deconv, y1, r["w"](w2))
    d_y1, dw2 = vjp2(g)
    d_y1 = r["dY1"](d_y1 * (y1 > 0))
    _, vjp1 = torch.func.vjp(lambda a, w: dat._deconv(a.permute(0, 3, 1, 2), w),
                             x.float(), r["w"](w1))
    dx, dw1 = vjp1(d_y1)
    return (dx.to(torch.bfloat16).contiguous(), dw1, d_y1.sum((0, 2, 3)), dw2,
            g.sum((0, 2, 3)))


def _front_bwd_rounding(g, xplane, w0, b0, w1, out, skip=""):
    """``dep_encode_front_bwd_plain_bf16`` written out, leaving out the
    rounding of ``skip`` ("p0", "dP0" or "w")."""
    r = {k: _keep if k == skip else dfr._bf16 for k in ("p0", "dP0", "w")}
    x4 = xplane.float()[:, None]
    w0r, w1r = r["w"](w0), r["w"](w1)
    pf = F.relu(F.conv2d(x4, w0r, r["w"](b0), 2, 1))
    gm = (dfr._bf16(g) * (out > 0)).permute(0, 3, 1, 2)
    _, vjp1 = torch.func.vjp(dfr._conv, r["p0"](pf), w1r)
    d_p0, dw1 = vjp1(gm)
    d_p0 = r["dP0"](d_p0 * (pf > 0))
    _, vjp0 = torch.func.vjp(dfr._conv, x4, w0r)
    dx, dw0 = vjp0(d_p0)
    return (dx[:, 0].to(torch.bfloat16), dw0, d_p0.sum((0, 2, 3)), dw1, gm.sum((0, 2, 3)))


@pytest.mark.parametrize("kernel,skip", [("K4", "g"), ("K4", "dY1"), ("K4", "w"),
                                         ("K5", "p0"), ("K5", "dP0"), ("K5", "w")])
def test_bars_catch_a_left_out_rounding(kernel, skip):
    """The bars that hold the plain versions against the TPU kernel here
    (and the kernels against the plain versions on the card, at 1e-3 of
    dx not bit-equal) fail a copy of the plain version that leaves out one
    rounding point, at both test shapes of each kernel; the copy with
    every rounding point is the plain version, bit for bit."""
    if kernel == "K4":
        cases = [_tail_case(*a)[0] for a in ((1, 5, 9, 20, 24, 30), (2, 4, 6, 32, 8, 31))]
        full, names, fn = decode_aff_tail_bwd_plain_bf16, TAIL_NAMES, _tail_bwd_rounding
    else:
        cases = [_front_case(*a)[0] for a in ((2, 16, 44, 96, 40), (1, 12, 20, 32, 41))]
        full, names, fn = dep_encode_front_bwd_plain_bf16, FRONT_NAMES, _front_bwd_rounding
    for args in cases:
        ref = full(*args)
        assert all(torch.equal(a, b) for a, b in zip(fn(*args), ref))
        with pytest.raises(AssertionError):
            assert_grads(f"{kernel} without the {skip} rounding, vs the plain version:",
                         names, fn(*args, skip=skip), [r.float().numpy() for r in ref])


def test_bf16_functions_run_their_plain_backwards():
    """Under autograd a bf16 input goes through the autograd Functions to
    the bf16 plain backwards on the CPU, with a bf16 input gradient and f32
    weight gradients."""
    port_args, _ = _tail_case(1, 3, 4, 16, 8, seed=32)
    g, xb, w1, w2, _ = port_args
    x_, b1, b2 = xb.clone().requires_grad_(), torch.zeros(16), torch.zeros(8)
    w1_, w2_ = w1.clone().requires_grad_(), w2.clone().requires_grad_()
    out = DecodeAffTailFunction.apply(x_, w1_, b1, w2_, b2)
    assert out.dtype == torch.float32
    out.backward(g)
    want = decode_aff_tail_bwd_plain_bf16(g, xb, w1, w2, decode_aff_tail_plain_bf16_y1(
        xb, w1, b1, w2, b2)[1])
    assert x_.grad.dtype == torch.bfloat16 and torch.equal(x_.grad, want[0])
    assert w1_.grad.dtype == torch.float32 and torch.equal(w1_.grad, want[1])
    assert torch.equal(w2_.grad, want[3])


# ---- BatchNorm in train mode on bf16 ----

def test_bf16_batchnorm_matches_flax():
    """The port's train-mode BatchNorm on a bf16 input against the JAX
    package's (Flax ``BatchNorm(dtype=bf16, param_dtype=f32)``): output
    within one bf16 ulp, running statistics in f32 within 1e-5 relative;
    backward from the same bf16 cotangent: the input gradient (bf16) within
    one bf16 ulp of max |ref|, the scale and bias gradients (f32) within
    1e-5. Flax rounds the input gradient's two parts (through the
    normalisation and through the statistics) to bf16 apart and adds them
    in bf16; the library rounds once. How many elements that moves, and how
    far each lies from float64, is printed, as are Flax's fast variance
    E[x^2] - E[x]^2 and the library's, on inputs whose mean is 10x their
    spread."""
    rng = np.random.default_rng(50)
    x = bf16_values(rng.standard_normal((2, 6, 10, 8)) * 0.5 + 5.0)     # NHWC
    g = bf16_values(rng.standard_normal(x.shape))
    scale, bias = rng.uniform(0.5, 1.5, 8), rng.standard_normal(8) * 0.1
    mean0, var0 = rng.standard_normal(8) * 0.1, rng.uniform(0.5, 1.5, 8)
    jbn = JaxBatchNorm(use_running_average=False, dtype=jnp.bfloat16)
    params = {"BatchNorm_0": {"scale": jnp.asarray(scale, jnp.float32),
                              "bias": jnp.asarray(bias, jnp.float32)}}
    stats0 = {"BatchNorm_0": {"mean": jnp.asarray(mean0, jnp.float32),
                              "var": jnp.asarray(var0, jnp.float32)}}
    (ref, mut), vjp = jax.vjp(
        lambda xx, p: jbn.apply({"params": p, "batch_stats": stats0}, xx,
                                mutable=["batch_stats"]),
        jnp.asarray(x, jnp.bfloat16), params, has_aux=False)
    assert ref.dtype == jnp.bfloat16
    ref_dx, ref_dp = vjp((jnp.asarray(g, jnp.bfloat16), jax.tree_util.tree_map(
        jnp.zeros_like, mut)))
    bn = BatchNorm(8).train()
    with torch.no_grad():
        bn.weight.copy_(t(scale)), bn.bias.copy_(t(bias))
        bn.running_mean.copy_(t(mean0)), bn.running_var.copy_(t(var0))
    xt = torch.from_numpy(nchw(x)).bfloat16().requires_grad_()
    out = bn(xt)
    assert out.dtype == torch.bfloat16
    ref_out = np.asarray(jnp.asarray(ref, jnp.float32))
    assert rel_to_max(out.detach().float().numpy(), nchw(ref_out)) <= ULP
    stats = mut["batch_stats"]["BatchNorm_0"]
    for name, port, jref in (("mean", bn.running_mean, stats["mean"]),
                             ("var", bn.running_var, stats["var"])):
        err = rel_to_max(port.numpy(), np.asarray(jref))
        print(f"running {name}: {err:.2e} of max |ref|")
        assert err <= 1e-5
    out.backward(torch.from_numpy(nchw(g)).bfloat16())
    assert xt.grad.dtype == torch.bfloat16 and bn.weight.grad.dtype == torch.float32
    jdx = nchw(np.asarray(jnp.asarray(ref_dx, jnp.float32)))
    dx_err = rel_to_max(xt.grad, jdx)
    ds_err = rel_to_max(bn.weight.grad, ref_dp["BatchNorm_0"]["scale"])
    db_err = rel_to_max(bn.bias.grad, ref_dp["BatchNorm_0"]["bias"])
    xd = torch.from_numpy(nchw(x)).double().requires_grad_()
    m = xd.mean((0, 2, 3), keepdim=True)
    v = ((xd - m) ** 2).mean((0, 2, 3), keepdim=True)
    ((xd - m) / torch.sqrt(v + 1e-5) * torch.from_numpy(scale)[None, :, None, None]).backward(
        torch.from_numpy(nchw(g)).double())
    print(f"backward: dx {dx_err:.2e} of max |ref| "
          f"({np.mean(xt.grad.float().numpy() != jdx):.2e} of it not bit-equal), dscale "
          f"{ds_err:.2e}, dbias {db_err:.2e}; dx from float64 (relative L2): port "
          f"{norm_rel_err(xt.grad.double(), xd.grad):.2e}, Flax "
          f"{norm_rel_err(jdx.astype(np.float64), xd.grad):.2e}")
    assert dx_err <= ULP and ds_err <= 1e-5 and db_err <= 1e-5
    xf = torch.from_numpy(x)
    fast = (xf * xf).mean((0, 1, 2)) - xf.mean((0, 1, 2)) ** 2
    mean, var = torch.zeros(8), torch.zeros(8)
    F.batch_norm(xt.detach(), mean, var, None, None, True, 1.0, 1e-5)
    n = x.size // 8
    exact = torch.from_numpy(x).double().var((0, 1, 2), correction=0)
    print(f"batch variance against float64: fast form {rel_to_max(fast, exact):.2e}, the "
          f"library's {rel_to_max(var * ((n - 1) / n), exact):.2e} of max (both f32)")


# ---- why the bf16 gradients lie far from the f32 ones ----

class _Widen(torch.autograd.Function):
    """bf16 to f32 whose backward rounds the cotangent to bf16, as the VJP
    of JAX's ``astype`` does."""

    @staticmethod
    def forward(ctx, x):
        return x.float()

    @staticmethod
    def backward(ctx, g):
        return g.to(torch.bfloat16)


def flax_rounding_batchnorm(bn, x):
    """Train-mode BatchNorm on bf16 rounding as Flax's does: x widened twice
    (for the statistics and for the normalisation), so that the two parts of
    its cotangent are rounded to bf16 apart and added in bf16; the fast
    variance."""
    xs = _Widen.apply(x)
    mean = xs.mean((0, 2, 3))
    var = ((xs * xs).mean((0, 2, 3)) - mean * mean).clamp_min(0)
    with torch.no_grad():
        bn.running_mean.lerp_(mean, bn.momentum)
        bn.running_var.lerp_(var, bn.momentum)
        bn.num_batches_tracked.add_(1)
    mul = torch.rsqrt(var + bn.eps) * bn.weight
    y = (_Widen.apply(x) - mean[:, None, None]) * mul[:, None, None] + bn.bias[:, None, None]
    return y.to(torch.bfloat16)


def port_train_step(name, precision, batch=None, relu_masks=None, flax_bn=False):
    """The port's loss and model after one forward and backward in train
    mode, from the JAX model's weights, on ``batch`` (the JAX step's by
    default), and the masks that its ``nn.ReLU`` modules took, in call
    order; ``relu_masks`` (such a record) makes them take those instead;
    ``flax_bn`` makes every BatchNorm round as Flax's does."""
    jcfg, _, variables = jax_bf16_model(name)
    cfg = Config(**dict(dataclasses.asdict(jcfg), precision=precision))
    model = get_model(cfg, device="cpu")
    model.load_state_dict(from_jax_variables(variables, cfg))
    model.train()
    masks = collections.defaultdict(list)

    def take_mask(key):
        def hook(mod, inp, out):
            masks[key].append(inp[0].detach() > 0)
            if relu_masks is not None:
                return inp[0] * relu_masks[key][len(masks[key]) - 1].to(inp[0].dtype)
        return hook

    for key, mod in model.named_modules():
        if isinstance(mod, nn.ReLU):
            mod.register_forward_hook(take_mask(key))
        if flax_bn and isinstance(mod, BatchNorm):
            mod.forward = functools.partial(flax_rounding_batchnorm, mod)
    s = to_port(batch if batch is not None else train_batch(2, H, W, seed=4))
    loss_sum, _ = LossFunction(cfg)(s, model(s, need_inter=False))
    loss = loss_sum / 2
    loss.backward()
    return loss, model, masks


def test_bf16_gradient_gap_is_the_forwards_relu_masks():
    """At the train-step tests' weights (default configuration) the f32
    step's gradients move by more than 5e-2 relative L2 when only the rgb
    input moves by 2^-9 relative (+-, at random): the perturbation flips a
    few of the ReLU masks, and a gradient is a sum over the pixels each mask
    lets through. With the unperturbed run's masks frozen in, the median
    tensor's move falls by at least 40%; likewise for the bf16 step against
    the f32 one, whose forward flips more masks. Printed: each move, largest
    and median over the tensors, and the share of masks flipped."""
    batch = train_batch(2, H, W, seed=4)
    pert = dict(batch)
    rng = np.random.default_rng(0)
    pert["rgb"] = (batch["rgb"] * (1 + 2.0 ** -9 * rng.choice([-1, 1], batch["rgb"].shape))
                   ).astype(np.float32)

    def grads(model):
        return {n: p.grad.clone() for n, p in model.named_parameters()}

    def moved(tag, a, b):
        (ga, ma), (gb, mb) = a, b
        d = sorted(norm_rel_err(ga[n], gb[n]) for n in gb if gb[n].abs().max() > 0)
        flips = sum(int((x != y).sum()) for k in ma for x, y in zip(ma[k], mb[k]))
        total = sum(x.numel() for k in mb for x in mb[k])
        print(f"{tag}: gradients moved (relative L2) largest {d[-1]:.3e}, median "
              f"{d[len(d) // 2]:.3e}; ReLU masks flipped {flips / total:.2e} of {total}")
        return d[-1], d[len(d) // 2], flips / total

    runs = {}
    for tag, precision, b, frozen in (("f32", "f32", batch, False),
                                      ("f32 rgb moved", "f32", pert, False),
                                      ("f32 rgb moved, masks frozen", "f32", pert, True),
                                      ("bf16", "bf16", batch, False),
                                      ("bf16, f32 masks frozen", "bf16", batch, True)):
        _, model, masks = port_train_step(
            "default", precision, b, runs["f32"][1] if frozen else None)
        runs[tag] = grads(model), masks
    free = moved("f32, rgb x (1 +- 2^-9)", runs["f32 rgb moved"], runs["f32"])
    fz = moved("f32, rgb x (1 +- 2^-9), ReLU masks frozen", runs["f32 rgb moved, masks frozen"],
               runs["f32"])
    b16 = moved("bf16 against f32", runs["bf16"], runs["f32"])
    b16z = moved("bf16 against f32, ReLU masks frozen", runs["bf16, f32 masks frozen"],
                 runs["f32"])
    assert free[0] > GRAD_TOL and 0 < free[2] < b16[2]
    assert fz[1] <= 0.6 * free[1] and b16z[1] <= 0.6 * b16[1]


# ---- one bf16 train step against the JAX bf16 train step ----

@functools.lru_cache(maxsize=None)
def jax_bf16_train_step(name):
    """The JAX bf16 model's loss, its gradients and the new BatchNorm
    statistics after one train step on a seeded batch, both fused kernels in
    interpret mode (set and restored here: the cache outlives a
    monkeypatch)."""
    jcfg, jmodel, variables = jax_bf16_model(name)
    batch = train_batch(2, H, W, seed=4)
    jloss = jax_get_loss(jcfg)

    def loss_of(params):
        out, mut = jmodel.apply(
            {"params": params, "batch_stats": variables["batch_stats"]},
            batch, train=True, need_inter=False, mutable=["batch_stats"])
        loss_sum, _ = jloss(batch, out)
        return loss_sum / 2, mut["batch_stats"]

    saved = jax_dat.FORCE_PALLAS_INTERPRET, jax_def.FORCE_PALLAS_INTERPRET
    jax_dat.FORCE_PALLAS_INTERPRET = jax_def.FORCE_PALLAS_INTERPRET = True
    try:
        (loss, stats), grads = jax.jit(jax.value_and_grad(loss_of, has_aux=True))(
            variables["params"])
        result = jax.device_get((loss, stats, grads))
    finally:
        jax_dat.FORCE_PALLAS_INTERPRET, jax_def.FORCE_PALLAS_INTERPRET = saved
    return result


def check_train_step(name):
    """One bf16 train step of the port against the JAX one (the module's
    docstring gives the bars), beside the port's f32 step and a port step
    whose BatchNorm rounds as Flax's does."""
    jcfg, _, variables = jax_bf16_model(name)
    ref_loss, ref_stats, ref_grads = jax_bf16_train_step(name)
    loss, model, _ = port_train_step(name, "bf16")
    assert loss.dtype == torch.float32
    for pname, p in model.named_parameters():    # every parameter reached, in f32
        assert p.grad is not None and p.grad.dtype == torch.float32, pname
        assert torch.isfinite(p.grad).all() and torch.count_nonzero(p.grad) > 0, pname
    lerr = rel_err(loss.item(), ref_loss)

    def leaves(m):
        return dict(jax.tree_util.tree_leaves_with_path(
            grads_as_jax_tree(m, variables, jcfg)["params"]))

    ref = dict(jax.tree_util.tree_leaves_with_path(ref_grads))
    port = leaves(model)
    assert port.keys() == ref.keys()
    sref = dict(jax.tree_util.tree_leaves_with_path(ref_stats))
    sport = dict(jax.tree_util.tree_leaves_with_path(
        grads_as_jax_tree(model, variables, jcfg)["batch_stats"]))
    serr = max((rel_err(sport[k], sref[k]), jax.tree_util.keystr(k)) for k in sref)
    loss32, model32, _ = port_train_step(name, "f32")
    f32 = leaves(model32)
    flax_bn = leaves(port_train_step(name, "bf16", flax_bn=True)[1])
    keys = [k for k in ref if np.any(np.asarray(ref[k]) != 0)]

    def bar(noise):
        return min(max(GRAD_TOL, 2 * noise), GRAD_CAP)

    rows = [(norm_rel_err(port[k], ref[k]), norm_rel_err(ref[k], f32[k]),
             float(np.linalg.norm(port[k]) / np.linalg.norm(ref[k])),
             jax.tree_util.keystr(k)) for k in keys]
    worst = max(rows, key=lambda r: r[0] / bar(r[1]))
    ratios = [r[2] for r in rows]
    fb = sorted(norm_rel_err(flax_bn[k], ref[k]) for k in keys)
    d = sorted(r[0] for r in rows)
    g32 = max(norm_rel_err(p.grad, p32.grad) for p, p32 in
              zip(model.parameters(), model32.parameters()) if p32.grad.abs().max() > 0)
    print(f"{name}: loss {loss.item():.5f} vs JAX {float(ref_loss):.5f} (rel {lerr:.2e}); "
          f"gradients within {GRAD_TOL} rel L2: {sum(x <= GRAD_TOL for x in d)} of "
          f"{len(d)}, largest {d[-1]:.2e}, median {d[len(d) // 2]:.2e}, nearest its bar "
          f"{worst[0]:.2e} at {worst[3]} (JAX bf16 vs f32 {worst[1]:.2e}, bar "
          f"{bar(worst[1]):.2e}); norms {min(ratios):.3f} to {max(ratios):.3f} of JAX's; "
          f"with Flax's BatchNorm rounding: largest {fb[-1]:.2e}, median "
          f"{fb[len(fb) // 2]:.2e}; BN statistics {serr[0]:.2e}; port bf16 vs port f32: "
          f"loss rel {rel_err(loss.item(), loss32.item()):.2e}, largest gradient rel L2 "
          f"{g32:.2e}")
    assert lerr <= LOSS_TOL
    for dist, noise, ratio, key in rows:
        assert dist <= bar(noise), f"gradient {key}: rel L2 {dist:.3e}, bf16 {noise:.3e}"
        assert 1 / NORM_RATIO <= ratio <= NORM_RATIO, f"gradient {key}: norm x{ratio:.3f}"
    assert serr[0] <= BN_TOL, f"BN statistics {serr[1]}: {serr[0]:.3e}"


@pytest.mark.parametrize("name", ["loop"])
def test_bf16_train_step_matches_jax_bf16_train_step(name):
    check_train_step(name)
