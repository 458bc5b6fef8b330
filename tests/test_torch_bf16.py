"""bf16 serving (``precision='bf16'``) in the port, held against the JAX
package on the CPU.

K2-bf16's and K3-bf16's plain versions (``decode_aff_tail_plain_bf16``,
``dep_encode_front_plain_bf16``), which the card holds the kernels against,
are held against the JAX TPU kernels (``_fwd_pallas`` in interpret mode, in
bf16) and against the JAX CPU paths (``*_reference``), within one bf16 ulp
of the largest output: 2^-7 of max |output|. The Pallas kernels round where
the plain versions do (y1 or conv0's output after bias and ReLU, then the
output, each once after an f32 sum); the ``*_reference`` paths round each
conv's output and then add the bias in bf16, so they round twice and sit up
to one ulp off.

The whole bf16 model, on the same weights (carried by
``from_jax_variables``) and seeded inputs, is held within the JAX package's
own bf16 bar (``tests/test_precision.py``: rtol 0.1, atol 0.05) of the JAX
bf16 model, with both JAX fused kernels in interpret mode so that K2 and K3
round at the same points. The two still round elsewhere at known places:
the stock convs (the JAX ``Conv`` rounds its output, then adds the bias in
bf16; the library adds the bias before it rounds), S2D's 1x1 MLP (JAX adds
its planes one bf16 add at a time; the port's 1x1 conv sums in f32) and, at
batch 1 only, the heads' stage 2, whose JAX tap-major route sums its nine
taps in bf16 where the port's conv sums in f32.

Then the dtypes along the path, and the entry points: ``Predictor``,
``Engine.eval_step`` and ``Engine.train_step`` in bf16, ``main``'s training
in bf16, and the kernels under autograd on a bf16 input (their bf16
backwards, held against the JAX package in ``tests/test_torch_bf16_train.py``).
"""

import dataclasses
import functools
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nlspn_eccv20_tpu.ops.pallas.dec_aff_tail as jax_dat
import nlspn_eccv20_tpu.ops.pallas.dep_encode_front as jax_def
import nlspn_eccv20_tpu_torch.models.nlspn as nlspn_mod
from nlspn_eccv20_tpu.config import Config as JaxConfig
from nlspn_eccv20_tpu.models import get_model as jax_get_model
from nlspn_eccv20_tpu_torch import main as cli_main
from nlspn_eccv20_tpu_torch.config import Config, parse_args
from nlspn_eccv20_tpu_torch.models import get_model
from nlspn_eccv20_tpu_torch.ops.kernels import dec_aff_tail as dat_mod
from nlspn_eccv20_tpu_torch.ops.kernels import dep_encode_front as def_mod
from nlspn_eccv20_tpu_torch.ops.kernels.dec_aff_tail import (
    decode_aff_tail, decode_aff_tail_plain, decode_aff_tail_plain_bf16)
from nlspn_eccv20_tpu_torch.ops.kernels.dep_encode_front import (
    dep_encode_front, dep_encode_front_plain, dep_encode_front_plain_bf16)
from nlspn_eccv20_tpu_torch.serve import Predictor
from nlspn_eccv20_tpu_torch.train import Engine
from nlspn_eccv20_tpu_torch.utils.weights import _conv_w, _convt_w, from_jax_variables
from test_torch_model import TINY, nchw, random_variables, sample
from test_torch_train import train_batch

H, W = 32, 48
ULP = 2.0 ** -7                # one bf16 ulp, relative to the largest output
MODEL_RTOL, MODEL_ATOL = 0.1, 0.05   # tests/test_precision.py's bf16 bar
CONFIGS = {"default": {},
           "offset": {"offset": True, "offset_window": 2, "offset_neighbor_loop": "scan"},
           "loop": {"use_GRU": False, "prop_impl": "pallas"}}


def t(a):
    return torch.from_numpy(np.asarray(a, np.float32))


def bf16_values(a):
    """``a`` rounded to bf16, as f32 numpy."""
    return np.array(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32))


def assert_within_ulp(name, port, ref):
    port = np.asarray(port.float() if isinstance(port, torch.Tensor) else port, np.float32)
    ref = np.asarray(ref, np.float32)
    assert port.shape == ref.shape, name
    err, scale = np.max(np.abs(port - ref)), np.max(np.abs(ref))
    assert err <= ULP * scale, f"{name}: max |d| {err:.3e} > 2^-7 x {scale:.3f}"


# ---- K2-bf16 and K3-bf16: the plain versions against the TPU kernels ----

def _tail_inputs(b, hg, wg, c, k, seed=20, m=16):
    rng = np.random.default_rng(seed)
    x = np.maximum(rng.standard_normal((b, hg, wg, c)), 0).astype(np.float32)
    w1 = (rng.standard_normal((3, 3, c, m)) * (c * 9 / 4) ** -0.5).astype(np.float32)
    b1 = (rng.standard_normal(m) * 0.1).astype(np.float32)
    w2 = (rng.standard_normal((3, 3, m, k)) * (m * 9 / 4) ** -0.5).astype(np.float32)
    b2 = (rng.standard_normal(k) * 0.1).astype(np.float32)
    return x, w1, b1, w2, b2


@pytest.mark.parametrize("b,hg,wg,c,k", [
    (1, 5, 9, 20, 24),         # an odd grid, K = 24, C not in whole channel stages
])
def test_decode_aff_tail_plain_bf16_matches_the_tpu_kernel(monkeypatch, b, hg, wg, c, k):
    monkeypatch.setattr(jax_dat, "FORCE_PALLAS_INTERPRET", True)
    x, w1, b1, w2, b2 = _tail_inputs(b, hg, wg, c, k)
    xj = jnp.asarray(x, jnp.bfloat16)
    ref = jax_dat._fwd_pallas(xj, *map(jnp.asarray, (w1, b1, w2, b2)))
    assert ref.dtype == jnp.bfloat16
    args = (torch.from_numpy(x).bfloat16(), _convt_w(w1), t(b1), _convt_w(w2), t(b2))
    out = decode_aff_tail_plain_bf16(*args)
    assert out.dtype == torch.float32
    assert torch.equal(out, out.bfloat16().float())      # bf16 values
    assert_within_ulp("vs _fwd_pallas", out, np.asarray(ref.astype(jnp.float32)))
    # the CPU path rounds each deconv's output, then adds its bias in bf16
    cpu = jax_dat.decode_aff_tail_reference(xj, *map(jnp.asarray, (w1, b1, w2, b2)))
    assert_within_ulp("vs decode_aff_tail_reference", out,
                      np.asarray(cpu.astype(jnp.float32)))
    # the wrapper takes a bf16 x to K2-bf16 (its plain version on the CPU)
    assert torch.equal(decode_aff_tail(*args), out)
    assert not torch.equal(out, decode_aff_tail_plain(t(x), *args[1:]))


def _front_inputs(b, h, w, c1, seed=21, m=16):
    rng = np.random.default_rng(seed)
    return (bf16_values(rng.random((b, h, w))),        # the model's rounded plane
            (rng.standard_normal((3, 3, 1, m)) * 0.3).astype(np.float32),
            (rng.standard_normal(m) * 0.1).astype(np.float32),
            (rng.standard_normal((3, 3, m, c1)) * 0.1).astype(np.float32),
            (rng.standard_normal(c1) * 0.1).astype(np.float32))


@pytest.mark.parametrize("b,h,w,c1", [
    (2, 16, 44, 96),           # Wo = 11 and C1 = 96: one and a half 64-channel groups
])
def test_dep_encode_front_plain_bf16_matches_the_tpu_kernel(monkeypatch, b, h, w, c1):
    monkeypatch.setattr(jax_def, "FORCE_PALLAS_INTERPRET", True)
    x, w0, b0, w1, b1 = _front_inputs(b, h, w, c1)
    jargs = tuple(map(jnp.asarray, (x, w0, b0, w1, b1)))
    ref = jax_def._fwd_pallas(*jargs, jnp.bfloat16)
    assert ref.dtype == jnp.bfloat16
    args = (torch.from_numpy(x).bfloat16(), _conv_w(w0), t(b0), _conv_w(w1), t(b1))
    out = dep_encode_front_plain_bf16(*args)
    assert out.dtype == torch.bfloat16 and out.is_contiguous()
    assert_within_ulp("vs _fwd_pallas", out, np.asarray(ref.astype(jnp.float32)))
    # the CPU path rounds each conv's output, then adds its bias in bf16
    cpu = jax_def.dep_encode_front_reference(jargs[0].astype(jnp.bfloat16), *jargs[1:])
    assert_within_ulp("vs dep_encode_front_reference", out,
                      np.asarray(cpu.astype(jnp.float32)))
    assert torch.equal(dep_encode_front(*args), out)
    assert not torch.equal(out.float(), dep_encode_front_plain(t(x), *args[1:]))


def test_bf16_kernels_under_autograd_raise(monkeypatch):
    """A bf16 tensor that requires grad no longer raises: it reaches the
    autograd Function and, on the CPU, its plain bf16 backward, never the
    f32 one (which raises here if it is called)."""
    seen = []
    for mod, f32_bwd, bf16_bwd in ((dat_mod, "decode_aff_tail_bwd_plain",
                                    "decode_aff_tail_bwd_plain_bf16"),
                                   (def_mod, "dep_encode_front_bwd_plain",
                                    "dep_encode_front_bwd_plain_bf16")):
        monkeypatch.setattr(mod, f32_bwd, lambda *a: pytest.fail("the f32 backward ran"))
        real = getattr(mod, bf16_bwd)
        monkeypatch.setattr(mod, bf16_bwd, lambda *a, _r=real, _n=bf16_bwd: (
            seen.append(_n), _r(*a))[1])
    x, w1, b1, w2, b2 = _tail_inputs(1, 3, 4, 16, 8)
    xb = torch.from_numpy(x).bfloat16().requires_grad_()
    decode_aff_tail(xb, _convt_w(w1), t(b1), _convt_w(w2), t(b2)).sum().backward()
    assert xb.grad.dtype == torch.bfloat16
    w1g = _convt_w(w1).requires_grad_()
    decode_aff_tail(xb.detach(), w1g, t(b1), _convt_w(w2), t(b2)).sum().backward()
    assert w1g.grad.dtype == torch.float32
    p, w0, b0, w1, b1 = _front_inputs(1, 8, 8, 16)
    pb = torch.from_numpy(p).bfloat16().requires_grad_()
    dep_encode_front(pb, _conv_w(w0), t(b0), _conv_w(w1), t(b1)).float().sum().backward()
    assert pb.grad.dtype == torch.bfloat16
    assert seen == ["decode_aff_tail_bwd_plain_bf16"] * 2 + ["dep_encode_front_bwd_plain_bf16"]


# ---- the whole bf16 model against the JAX bf16 model ----

@functools.lru_cache(maxsize=None)
def jax_bf16_model(name):
    """The JAX bf16 model and seeded values for every variable (shaped by
    tracing its init, not compiling it)."""
    jcfg = JaxConfig(**dict(TINY, prop_time=2, precision="bf16"), **CONFIGS[name])
    jmodel = jax_get_model(jcfg)
    shapes = jax.eval_shape(lambda k: jmodel.init(k, sample(1, H, W), train=False),
                            jax.random.PRNGKey(0))
    return jcfg, jmodel, random_variables(shapes, seed=1)


@functools.lru_cache(maxsize=None)
def jax_bf16_forward(name, b):
    """The JAX bf16 model's eval forward, both fused kernels in interpret
    mode (set and restored here: the cache outlives a monkeypatch)."""
    jcfg, jmodel, variables = jax_bf16_model(name)
    s = sample(b, H, W, seed=2)
    saved = jax_dat.FORCE_PALLAS_INTERPRET, jax_def.FORCE_PALLAS_INTERPRET
    jax_dat.FORCE_PALLAS_INTERPRET = jax_def.FORCE_PALLAS_INTERPRET = True
    try:
        ref = jax.jit(lambda v, x: jmodel.apply(v, x, train=False, need_inter=False))(
            variables, s)
        ref = {k: np.asarray(ref[k]) for k in ("pred", "pred_init")}
    finally:
        jax_dat.FORCE_PALLAS_INTERPRET, jax_def.FORCE_PALLAS_INTERPRET = saved
    return s, ref


def port_bf16(name, precision="bf16"):
    jcfg, _, variables = jax_bf16_model(name)
    cfg = Config(**dict(dataclasses.asdict(jcfg), precision=precision))
    model = get_model(cfg, device="cpu")
    model.load_state_dict(from_jax_variables(variables, cfg))
    return cfg, model.eval()


def port_forward(model, s):
    with torch.inference_mode():
        return model({"rgb": torch.from_numpy(nchw(s["rgb"])),
                      "dep": torch.from_numpy(nchw(s["dep"]))}, need_inter=False)


@pytest.mark.parametrize("name,b", [("default", 2), ("offset", 2), ("loop", 2),
                                    ("default", 1)])
def test_bf16_model_matches_jax_bf16_model(name, b):
    """At batch 2 every rounding point but the stock convs' bias and S2D's
    MLP is shared. At batch 1 the JAX heads' stage 2 also sums its taps in
    bf16 (its tap-major route), so the port is held at the same bar, which
    is the JAX package's own for bf16 against f32."""
    s, ref = jax_bf16_forward(name, b)
    _, model = port_bf16(name)
    out = port_forward(model, s)
    mask = nchw(s["dep"] > 0)
    for key in ("pred", "pred_init"):
        port = out[key].numpy()
        assert out[key].dtype == torch.float32
        gap = np.max(np.abs(port - nchw(ref[key])))
        print(f"{name} b={b} {key}: max |port - JAX| {gap:.3e} "
              f"(max |JAX| {np.max(np.abs(ref[key])):.3f})")
        np.testing.assert_allclose(port, nchw(ref[key]), rtol=MODEL_RTOL, atol=MODEL_ATOL)
    assert np.array_equal(out["pred"].numpy()[mask], nchw(s["dep"])[mask])


# ---- dtypes along the path ----

def test_bf16_dtypes_along_the_path(monkeypatch):
    """Every conv's output is bf16, K2 and K3 get bf16, every propagation
    input is f32, the outputs are f32 and the parameters stay f32; and the
    output is not the f32 model's."""
    cfg, model = port_bf16("default")
    seen = {"conv": set(), "kernels": [], "prop": set()}
    for m in model.modules():
        if isinstance(m, (torch.nn.Conv2d, torch.nn.ConvTranspose2d)):
            m.register_forward_hook(lambda _m, _i, o: seen["conv"].add(o.dtype))
    for name in ("decode_aff_tail", "dep_encode_front"):
        fn = getattr(nlspn_mod, name)
        monkeypatch.setattr(nlspn_mod, name, lambda x, *a, _f=fn, _n=name: (
            seen["kernels"].append((_n, x.dtype)), _f(x, *a))[1])
    step = nlspn_mod.prop_step
    monkeypatch.setattr(nlspn_mod, "prop_step", lambda *a, **k: (
        seen["prop"].update(x.dtype for x in a if isinstance(x, torch.Tensor)),
        step(*a, **k))[1])
    s, _ = jax_bf16_forward("default", 2)
    out = port_forward(model, s)
    assert seen["conv"] == {torch.bfloat16}
    assert sorted(set(seen["kernels"])) == [("decode_aff_tail", torch.bfloat16),
                                            ("dep_encode_front", torch.bfloat16)]
    assert seen["prop"] == {torch.float32}
    for key in ("pred", "pred_init", "confidence", "aff"):
        assert out[key].dtype == torch.float32, key
    assert all(p.dtype == torch.float32 for p in model.parameters())
    _, f32 = port_bf16("default", precision="f32")
    assert not torch.equal(out["pred"], port_forward(f32, s)["pred"])


# ---- the entry points ----

def _requests(n=2, h=30, w=44, seed=5):
    rng = np.random.default_rng(seed)
    rgbs = [rng.integers(0, 256, (h, w, 3), dtype=np.uint8) for _ in range(n)]
    deps = [np.where(rng.random((h, w)) < 0.05, rng.uniform(0.5, 10.0, (h, w)),
                     0.0).astype(np.float32) for _ in range(n)]
    return rgbs, deps


def test_predictor_serves_bf16_and_one_checkpoint_loads_into_both(tmp_path):
    cfg, model = port_bf16("default")
    path = tmp_path / "model.pt"
    torch.save({"net": model.state_dict()}, path)
    rgbs, deps = _requests()
    answers = {}
    for precision in ("f32", "bf16"):
        p = Predictor(cfg.replace(precision=precision), checkpoint=str(path), device="cpu")
        answers[precision] = p.predict_batch(rgbs, deps)
    for out, dep in zip(answers["bf16"], deps):
        assert out.dtype == np.float32 and out.shape == dep.shape
        assert np.isfinite(out).all()
        assert np.array_equal(out[dep > 0], dep[dep > 0])
    gap = max(np.max(np.abs(a - b)) for a, b in zip(answers["bf16"], answers["f32"]))
    assert 0 < gap


def test_engine_evaluates_in_bf16_and_does_not_train_in_bf16():
    """The Engine evaluates in bf16 and (since bf16 training was ported)
    trains a step in bf16 too: f32 gradients, f32 weights after the step."""
    cfg = Config(**dict(TINY, prop_time=2, precision="bf16"))
    eng = Engine(cfg, device="cpu")
    eng.init_state()
    batch = eng.put_batch(train_batch(2, H, W, seed=4))
    res = eng.eval_step(batch)
    assert res["output"]["pred"].dtype == torch.float32
    assert torch.isfinite(res["metric"]).all() and torch.isfinite(res["loss_val"]).all()
    before = {k: v.clone() for k, v in eng.model.state_dict().items()}
    aux = eng.train_step(batch)
    assert aux["loss"].dtype == torch.float32 and torch.isfinite(aux["loss"])
    assert aux["output"]["pred"].dtype == torch.float32
    for name, p in eng.model.named_parameters():
        assert p.grad is not None and p.grad.dtype == torch.float32, name
        assert torch.isfinite(p.grad).all() and p.dtype == torch.float32, name
    assert eng.step == 1
    assert not torch.equal(before["conv1_rgb.0.weight"], eng.model.conv1_rgb[0].weight)


def test_main_trains_not_in_bf16(tmp_path, monkeypatch):
    """``main --precision bf16`` trains (since bf16 training was ported):
    one epoch on the synthetic scenes, a checkpoint of f32 weights that an
    f32 Predictor loads. TensorBoard, which is optional, is left out: its
    import alone takes longer than the run."""
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    cfg = parse_args(["--platform", "cpu", "--precision", "bf16", "--data_name",
                      "Synthetic", "--test_pipeline", "--epochs", "1", "--batch_size",
                      "2", "--patch_height", "32", "--patch_width", "48", "--prop_time",
                      "2", "--GRU_hidden_dim", "16", "--GRU_input_dim", "16",
                      "--num_sample", "50", "--num_threads", "2", "--experiments_dir",
                      str(tmp_path)])
    cli_main.main(cfg)
    ckpts = list(tmp_path.rglob("model_*.pt"))
    assert len(ckpts) == 1
    net = torch.load(ckpts[0], weights_only=True)["net"]
    assert all(v.dtype != torch.bfloat16 for v in net.values())
    rgbs, deps = _requests(n=1)
    f32 = Predictor(cfg.replace(precision="f32", platform=None), checkpoint=str(ckpts[0]),
                    device="cpu")
    out = f32.predict_batch(rgbs, deps)[0]
    assert out.shape == deps[0].shape and np.isfinite(out).all()
