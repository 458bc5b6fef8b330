"""The port's interleave microbenchmarks
(``nlspn_eccv20_tpu_torch.devtools.microbench_interleave`` and
``microbench_asm``) held against the JAX package's ``devtools/`` scripts on
the CPU, where every kernel wrapper runs its plain PyTorch version. The
TPU kernels run in interpret mode through the scripts' own wrappers.

- K11a (``interleave_asm``): its plain version equal bits to the script's
  ``pallas_asm`` (a closure of its ``main()``, caught by replacing ``bench``)
  at B=12 on phases whose padding is random.
- K11b (``interleave_strided``): equal bits to ``run``'s kernel with
  ``k_strided`` at B=1 (``run`` reads the module's ``B``) and to the
  script's ``interleave_flat`` of the flattened window at B=12.
- K11c (``tile_repeat_probe``): equal bits to ``k_repeat`` at B=1, and not
  the interleave (``pltpu.repeat`` tiles blockwise).
- K11d (``interleave_onehot``): equal bits to ``k_matmul`` with the one-hot
  E, within 1e-5 of max |ref| with a random E (sums of 304 products in
  another order).
- The layout changes equal bits to the script's closures; deconv0 in NCHW
  and channels-last within 1e-4 of max |ref| of its NHWC output (cuDNN's
  and XLA's conv sum 1,152 products in other orders).
- ``utils.device_time`` and the ``main()``s raise without a card, the
  ``main()``s run on the CPU when asked to, and the wrappers refuse a
  tensor on neither the CPU nor a card.

The JAX runs are shared through module-level caches (about 16 s of
interpret runs in all).
"""

import functools
import os
import sys
from unittest import mock

import jax.numpy as jnp
import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:   # the JAX scripts live in the root devtools/
    sys.path.insert(0, REPO)

from devtools import microbench_asm as jax_asm  # noqa: E402
from devtools import microbench_interleave as jax_il  # noqa: E402
from nlspn_eccv20_tpu_torch.devtools import microbench_asm as asm  # noqa: E402
from nlspn_eccv20_tpu_torch.devtools import microbench_interleave as il  # noqa: E402
from nlspn_eccv20_tpu_torch.utils import device_time  # noqa: E402


def t(a):
    return torch.from_numpy(np.array(a, np.float32))


def padded_phases(batch, seed):
    """(batch, 128, 64, 128) N(0, 1) phases, the padding random too."""
    return np.random.default_rng(seed).standard_normal((batch, 128, 64, 128)).astype(np.float32)


def assert_rel(name, port, ref, tol):
    """max |port - ref| <= tol * max |ref|."""
    port, ref = port.detach().numpy(), np.asarray(ref)
    assert port.shape == ref.shape, (name, port.shape, ref.shape)
    err = np.max(np.abs(port - ref))
    assert err <= tol * np.max(np.abs(ref)), \
        f"{name}: max abs err {err:.3e}, scale {np.max(np.abs(ref)):.3e}"


def assert_same_bits(name, port, ref):
    ref = np.asarray(ref)
    assert port.shape == ref.shape, (name, tuple(port.shape), ref.shape)
    assert np.array_equal(port.numpy(), ref), name


# ---- the JAX scripts, run once ----------------------------------------------

_BENCH = {}


def bench_lines():
    """{name: (fn, args)} of every line the JAX ``main()`` would time."""
    if not _BENCH:
        def record(name, fn, *args, bytes_=None):
            _BENCH[name] = fn, args

        with mock.patch.object(jax_il, "bench", record):
            jax_il.main()
    return _BENCH


_ASM = {}


def asm_kernel_out(kernel, e=None):
    """The TPU kernel through ``run``'s ``pallas_call`` at B=1 on
    ``padded_phases(1, 2)`` (and ``e``), in interpret mode; cached."""
    key = (kernel, None if e is None else e[0, 0, 0])
    if key not in _ASM:
        caught = {}

        def measure(fn, *args, **kw):
            caught["f"] = fn
            return 1.0

        extra = () if e is None else (jnp.asarray(e),)
        with mock.patch.object(jax_asm, "B", 1), mock.patch.object(jax_asm, "measure", measure):
            jax_asm.run(kernel.__name__, kernel, extra)
            _ASM[key] = np.asarray(caught["f"](padded_phases(1, 2), *extra))
    return _ASM[key]


def onehot_e():
    return asm.onehot_expansion().numpy()


def random_e():
    return np.random.default_rng(3).standard_normal((4, 76, 304)).astype(np.float32)


# ---- K11a ------------------------------------------------------------------

def test_k11a_plain_matches_the_tpu_kernel_in_interpret_mode():
    fn, _ = bench_lines()["Pallas mask+repeat assembly (27MB)"]
    ph = padded_phases(12, 1)
    assert_same_bits("interleave_asm", il.interleave_asm(t(ph)), fn(ph))


# ---- K11b ------------------------------------------------------------------

@pytest.mark.parametrize("ref", ["k_strided", "interleave_flat"])
def test_k11b_plain_is_the_strided_stores_and_the_interleave(ref):
    if ref == "k_strided":
        ph = padded_phases(1, 2)
        want = asm_kernel_out(jax_asm.k_strided)
    else:   # the script's closure, at its own B=12, on the flattened window
        ph = padded_phases(12, 1)
        fn, _ = bench_lines()["XLA flat->planar interleave (27MB)"]
        want = fn(ph[:, :, :58, :76].reshape(12, 128, 58 * 76))
    assert_same_bits("interleave_strided", asm.interleave_strided(t(ph)), want)


# ---- K11c ------------------------------------------------------------------

def test_k11c_plain_matches_the_tpu_kernel_in_interpret_mode():
    out = asm.tile_repeat_probe(t(padded_phases(1, 2)))
    assert_same_bits("tile_repeat_probe", out, asm_kernel_out(jax_asm.k_repeat))


def test_k11c_is_a_probe_not_the_interleave():
    ph = t(padded_phases(1, 2))
    probe, inter = asm.tile_repeat_probe(ph), il.interleave_window(ph)
    assert (probe - inter).abs().max() > 1.0
    assert not np.array_equal(asm_kernel_out(jax_asm.k_repeat), inter.numpy())
    # its own formula: phase by (y % 4, x % 4), the plane tiled blockwise
    y, x, c = np.arange(232)[:, None], np.arange(304)[None], np.arange(8)[:, None, None]
    want = ph[0].numpy()[((y % 4) * 4 + x % 4) * 8 + c, y % 58, x % 76]
    assert np.array_equal(probe[0].numpy(), want)


# ---- K11d ------------------------------------------------------------------

@pytest.mark.parametrize("which", ["onehot", "random"])
def test_k11d_plain_matches_the_tpu_kernel_in_interpret_mode(which):
    e = onehot_e() if which == "onehot" else random_e()
    out = asm.interleave_onehot(t(padded_phases(1, 2)), t(e))
    ref = asm_kernel_out(jax_asm.k_matmul, e)
    if which == "onehot":
        assert_same_bits("interleave_onehot", out, ref)
        assert_same_bits("interleave_onehot", out, il.interleave_window(t(padded_phases(1, 2))))
    else:
        assert_rel("interleave_onehot, random E", out, ref, 1e-5)


# ---- the plain layout changes and deconv0 ----------------------------------

@pytest.mark.parametrize("name,port", [
    ("XLA planar interleave 4x4 (27MB)", il.interleave),
    ("XLA flat->planar interleave (27MB)", il.interleave_flat),
    ("XLA planar de-interleave (27MB)", il.deinterleave),
    ("XLA NHWC->flat-planar transpose (54MB)", il.to_flat)])
def test_layout_changes_match_the_scripts_closures(name, port):
    fn, (x,) = bench_lines()[name]
    out = port(t(x))
    assert out.is_contiguous()
    assert_same_bits(name, out, fn(x))


@pytest.mark.parametrize("fmt", [torch.contiguous_format, torch.channels_last])
def test_deconv0_matches_the_scripts_nhwc_conv(fmt):
    fn, (x, k) = bench_lines()["deconv0 128->256 NHWC out"]
    assert isinstance(fn, functools.partial) and fn.keywords == {"dn": "NHWC"}
    x1 = np.asarray(x)[:1]
    xt = t(x1).permute(0, 3, 1, 2).contiguous(memory_format=fmt)
    w = il.deconv0_weight(t(k)).contiguous(memory_format=fmt)
    out = il.deconv0(xt, w)
    assert out.is_contiguous(memory_format=fmt)
    assert_rel("deconv0", out.permute(0, 2, 3, 1), fn(x1, k), 1e-4)


# ---- the entry points ------------------------------------------------------

def test_device_time_and_mains_raise_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for main in (il.main, asm.main):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            main()
    for fn in (device_time.device_durations_us, device_time.median_device_time_s):
        with pytest.raises(RuntimeError, match="CUDA card"):
            fn(lambda: None)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    with pytest.raises(ValueError, match="want CUDA tensors"):
        device_time.median_device_time_s(torch.neg, torch.zeros(2))


def test_mains_run_on_the_cpu_when_asked(capsys):
    """At B=1 with ``device="cpu"``: the checks hold, and no times."""
    ri = il.main(device="cpu", batch=1)
    ra = asm.main(device="cpu", batch=1)
    assert len(ri["lines"]) == 7 and all(row == {} for row in ri["lines"].values())
    assert ri["asm_equal"] and ri["deconv0_rel"] <= 1e-6
    assert len(ra) == 3 and all(row == {"equal": True} for row in ra.values())
    assert "K11d interleave_onehot" in capsys.readouterr().out


def test_wrappers_launch_or_raise_off_the_cpu():
    """A tensor on neither the CPU nor a card (``meta``) is refused: no
    wrapper falls back to its plain version. Malformed phases are refused
    on any device."""
    meta = functools.partial(torch.zeros, device="meta")
    ph = meta(1, 128, 64, 128)
    for fn, args in ((il.interleave_asm, (ph,)), (asm.interleave_strided, (ph,)),
                     (asm.tile_repeat_probe, (ph,)),
                     (asm.interleave_onehot, (ph, meta(4, 76, 304)))):
        with pytest.raises(ValueError, match="CUDA tensor"):
            fn(*args)
    with pytest.raises(ValueError, match="phases"):
        il.interleave_asm(torch.zeros(1, 128, 57, 76))
    with pytest.raises(ValueError, match="E "):
        asm.interleave_onehot(torch.zeros(1, 128, 58, 76), torch.zeros(4, 76, 300))
