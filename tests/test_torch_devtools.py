"""The port's devtools prototypes (``nlspn_eccv20_tpu_torch.devtools``)
held against the JAX package's ``devtools/`` prototypes, on the CPU, where
every kernel wrapper runs its plain PyTorch version.

- K10a (``deform_windowed``): its plain version against the TPU kernel
  ``_deform_pallas_core`` in interpret mode (3x3 at R = 2, 5x5 at R = 0:
  the interpret runs unroll every (u, v) of the window, so larger windows
  only cost time), and the autograd Function (K8's plain version as its
  backward) against ``jax.vjp`` of ``_deform_op`` (3x3, R = 1) on offsets
  that are integers inside the window, and fractions inside and beyond
  it, up to R + 1.5. Forward 1e-5 of max |ref|; each gradient 1e-5 of its largest
  entry (sums of up to (2R+2)^2 products a neighbour in another order).
- K10b (``deform_colgather``): its plain version against the TPU kernel
  ``deform_pallas(..., interpret=True)`` (R = 2) and against the JAX
  package's ``propagate_deformable_exact`` for offsets in [-R, R]; 1e-5.
- K10c (``probe_gather``): its plain version equal to
  ``jnp.take_along_axis`` of jnp's floor modulo, negative indices
  included.
- The entry points raise without a card, and run at a tiny size on the
  CPU when asked to.

The JAX runs are shared through module-level caches, as in
``test_torch_oplib.py``.
"""

import functools
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:   # devtools/exp_deform3.py imports bench
    sys.path.insert(0, REPO)

from devtools import exp_deform3 as jax_deform3  # noqa: E402
from devtools.exp_deform_prop_kernel import (  # noqa: E402
    _deform_op,
    _deform_pallas_core,
)
from nlspn_eccv20_tpu.ops.propagate import propagate_deformable_exact  # noqa: E402
from nlspn_eccv20_tpu_torch.devtools import exp_deform2, exp_deform3  # noqa: E402
from nlspn_eccv20_tpu_torch.devtools import measure as measure_mod  # noqa: E402
from nlspn_eccv20_tpu_torch.devtools.exp_deform_prop_kernel import (  # noqa: E402
    deform_windowed,
    propagate_deformable_pallas,
)

B, H, W = 2, 12, 20


def t(a):
    return torch.from_numpy(np.array(a, np.float32))


def assert_rel(name, port, ref, tol):
    """max |port - ref| <= tol * max |ref|."""
    port, ref = port.detach().numpy(), np.asarray(ref)
    assert port.shape == ref.shape, (name, port.shape, ref.shape)
    err = np.max(np.abs(port - ref))
    assert err <= tol * max(np.max(np.abs(ref)), 1e-30), \
        f"{name}: max abs err {err:.3e}, scale {np.max(np.abs(ref)):.3e}"


def planes(rng, kernel, off):
    k2 = kernel * kernel
    return (rng.standard_normal((B, H, W)).astype(np.float32), off,
            rng.standard_normal((B, k2, H, W)).astype(np.float32))


def offsets(rng, kernel, radius, past):
    """Half integers in [-R, R], half fractions in (-R - 1, R + 1) at least
    0.05 from an integer; with ``past``, a quarter moved out to
    +-(R + 1.5)."""
    shape = (B, 2 * kernel * kernel, H, W)
    frac = rng.integers(-radius - 1, radius + 1, shape) + rng.uniform(0.05, 0.95, shape)
    off = np.where(rng.random(shape) < 0.5, rng.integers(-radius, radius + 1, shape), frac)
    if past:
        off = np.where(rng.random(shape) < 0.25, (radius + 1.5) * np.sign(off - 0.1), off)
    return off.astype(np.float32)


# ---- K10a ------------------------------------------------------------------

_INTERPRET = {}


@pytest.mark.parametrize("kernel,radius", [(3, 2), (5, 0)])
def test_k10a_plain_matches_the_tpu_kernel_in_interpret_mode(kernel, radius):
    key = (kernel, radius)
    if key not in _INTERPRET:
        rng = np.random.default_rng(10 + kernel)
        inputs = planes(rng, kernel, offsets(rng, kernel, radius, past=True))
        _INTERPRET[key] = inputs, _deform_pallas_core(*inputs, kernel=kernel,
                                                      radius=radius)
    (feat, off, aff), ref = _INTERPRET[key]
    assert_rel("deform_windowed", deform_windowed(t(feat), t(off), t(aff), kernel, radius),
               ref, 1e-5)


_VJP = {}


def k10a_vjp():
    """Inputs, JAX's output and ``jax.vjp`` of ``_deform_op`` (3x3, R = 1;
    its forward the TPU kernel in interpret mode), computed once."""
    if not _VJP:
        rng = np.random.default_rng(20)
        feat, off, aff = planes(rng, 3, offsets(rng, 3, 1, past=True))
        g = rng.standard_normal((B, H, W)).astype(np.float32)

        @jax.jit
        def run(f, o, a, g):
            out, vjp = jax.vjp(functools.partial(_deform_op, kernel=3, radius=1), f, o, a)
            return out, vjp(g)

        _VJP["case"] = (feat, off, aff, g), run(feat, off, aff, g)
    return _VJP["case"]


@pytest.mark.parametrize("i,name", enumerate(["d_feat", "d_off", "d_aff"]))
def test_k10a_gradients_match_jax_vjp(i, name):
    (feat, off, aff, g), (ref, grads) = k10a_vjp()
    assert np.any(np.abs(off) > 1) and np.any(off == np.round(off))
    leaves = [t(a)[:, None] if j == 0 else t(a) for j, a in enumerate((feat, off, aff))]
    leaves = [x.requires_grad_(True) for x in leaves]
    out = propagate_deformable_pallas(*leaves, kernel=3, radius=1)
    assert_rel("forward", out[:, 0], ref, 1e-5)
    got = torch.autograd.grad(out, leaves, t(g)[:, None])[i]
    assert_rel(name, got[:, 0] if i == 0 else got, grads[i], 1e-5)


# ---- K10b ------------------------------------------------------------------

_COLGATHER = {}


def colgather_case():
    """NHWC inputs with offsets clip(N(0, 1.5^2), -R, R), R = 2, and the
    TPU kernel's output in interpret mode, computed once."""
    if not _COLGATHER:
        rng = np.random.default_rng(30)
        feat = rng.standard_normal((B, H, W, 1)).astype(np.float32)
        off = np.clip(rng.standard_normal((B, H, W, 18)) * 1.5, -2, 2).astype(np.float32)
        aff = (rng.standard_normal((B, H, W, 9)) * 0.11).astype(np.float32)
        _COLGATHER["case"] = (feat, off, aff), jax_deform3.deform_pallas(
            feat, off, aff, radius=2, interpret=True)
    return _COLGATHER["case"]


def nchw(a):
    return np.ascontiguousarray(np.transpose(a, (0, 3, 1, 2)))


def test_k10b_plain_matches_the_tpu_kernel_in_interpret_mode():
    (feat, off, aff), ref = colgather_case()
    out = exp_deform3.deform_pallas(t(nchw(feat)), t(nchw(off)), t(nchw(aff)), radius=2)
    assert_rel("deform_colgather", out, nchw(ref), 1e-5)


def test_k10b_plain_is_the_exact_gather_inside_the_window():
    (feat, off, aff), _ = colgather_case()
    ref = propagate_deformable_exact(jnp.asarray(feat), jnp.asarray(off), jnp.asarray(aff))
    out = exp_deform3.deform_pallas(t(nchw(feat)), t(nchw(off)), t(nchw(aff)), radius=2)
    assert_rel("deform_colgather vs exact", out, nchw(ref), 1e-5)


def test_k10b_is_3x3_only():
    feat, off, aff = torch.zeros(1, 1, 8, 8), torch.zeros(1, 50, 8, 8), torch.zeros(1, 25, 8, 8)
    with pytest.raises(ValueError, match="3x3 only"):
        exp_deform3.deform_pallas(feat, off, aff, kernel=5)


# ---- K10c ------------------------------------------------------------------

@pytest.mark.parametrize("axis", [0, 1])
def test_k10c_plain_is_take_along_axis_with_the_floor_modulo(axis):
    x, idx = exp_deform2.probe_inputs("cpu")
    rng = np.random.default_rng(40)
    for ind in (idx.numpy(), rng.integers(-300, 300, (64, 128)).astype(np.int32)):
        xj = jnp.asarray(x.numpy())
        ref = jnp.take_along_axis(xj, jnp.asarray(ind) % xj.shape[axis], axis=axis)
        out = exp_deform2.probe_gather(x, torch.from_numpy(ind), axis)
        assert np.array_equal(out.numpy(), np.asarray(ref))


# ---- the entry points ------------------------------------------------------

def test_entry_points_raise_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for main in (exp_deform3.main, exp_deform2.main):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            main()
    with pytest.raises(RuntimeError, match="CUDA card"):
        measure_mod.measure(lambda: None)


def test_wrappers_launch_or_raise_off_the_cpu():
    """A tensor on neither the CPU nor a card (``meta``) is refused: no
    wrapper falls back to its plain version."""
    meta = functools.partial(torch.zeros, device="meta")
    with pytest.raises(ValueError, match="CUDA tensor"):
        deform_windowed(meta(1, 8, 8), meta(1, 18, 8, 8), meta(1, 9, 8, 8))
    with pytest.raises(ValueError, match="radius"):
        deform_windowed(meta(1, 8, 8), meta(1, 18, 8, 8), meta(1, 9, 8, 8), radius=9)
    with pytest.raises(ValueError, match="CUDA tensor"):
        exp_deform3.deform_colgather(meta(1, 8, 8), meta(1, 18, 8, 8), meta(1, 9, 8, 8))
    with pytest.raises(ValueError, match="CUDA tensor"):
        exp_deform2.probe_gather(meta(4, 4), meta(4, 4, dtype=torch.int32), 0)


def test_mains_run_on_the_cpu_when_asked(capsys):
    """At a tiny size with ``device="cpu"``: the errors, and no times."""
    r3 = exp_deform3.main(device="cpu", shapes=[(1, 10, 14)])
    r2 = exp_deform2.main(device="cpu", shapes=[(1, 10, 14)])
    assert r3[(1, 10, 14)].keys() == {"max_err"} and r3[(1, 10, 14)]["max_err"] < 1e-5
    assert r2["probe"] == {0: True, 1: True}
    assert r2[(1, 10, 14)].keys() == {"max_err"} and r2[(1, 10, 14)]["max_err"] < 1e-5
    assert "colgather" in capsys.readouterr().out
