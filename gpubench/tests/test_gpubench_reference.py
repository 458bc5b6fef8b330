"""The benchmark's plain reference held against the port's CPU path at a
tiny size, for both configurations: the same weights load into both
(every name and shape), the eval and train forwards agree, and one
training step's loss and moved weights agree. The reference imports
neither the port nor JAX."""

import ast
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from gpubench.reference.model import forward, load_config
from gpubench.reference.train import readings
from gpubench.reference.weights import make_weights

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
CONFIGS = ("nlspn_fork", "nlspn_eccv20")
SMALL = dict(prop_time=3, GRU_hidden_dim=16, GRU_input_dim=16)


def fields(name, **changes):
    with open(os.path.join(ROOT, "gpubench", "configs", name + ".json")) as f:
        return {**json.load(f)["config"], **changes}


def port_model(f, weights):
    from nlspn_eccv20_tpu_torch.config import Config
    from nlspn_eccv20_tpu_torch.models import get_model

    model = get_model(Config(**f), "cpu")
    model.load_state_dict(weights)
    return model


@pytest.mark.parametrize("name", CONFIGS)
def test_weights_fit_the_port_at_full_size(name):
    f = fields(name)
    weights = make_weights(load_config(f), 3, "cpu")
    from nlspn_eccv20_tpu_torch.config import Config
    from nlspn_eccv20_tpu_torch.models import get_model

    own = get_model(Config(**f), "cpu").state_dict()
    assert sorted(own) == sorted(weights)
    assert all(own[k].shape == weights[k].shape and own[k].dtype == weights[k].dtype
               for k in own)


def test_weights_are_the_seeds():
    c = load_config(fields("nlspn_eccv20"))
    a, b, other = (make_weights(c, s, "cpu") for s in (2**31 + 5, 2**31 + 5, 6))
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["conv5.0.weight"], other["conv5.0.weight"])


def inputs(seed, b=2, h=32, w=48):
    g = torch.Generator().manual_seed(seed)
    gt = 1 + 4 * torch.rand(b, 1, h, w, generator=g)
    dep = gt * (torch.rand(b, 1, h, w, generator=g) < 0.1)
    return torch.randn(b, 3, h, w, generator=g), dep, gt


@pytest.mark.parametrize("train", (False, True), ids=("eval", "train"))
@pytest.mark.parametrize("name", CONFIGS)
def test_forward_matches_the_port(name, train):
    f = fields(name, **SMALL)
    c = load_config(f)
    weights = make_weights(c, 11, "cpu")
    model = port_model(f, weights).train(train)
    rgb, dep, _ = inputs(1)
    with torch.no_grad():
        got = model({"rgb": rgb, "dep": dep}, need_inter=False)["pred"]
        want = forward(weights, c, rgb, dep, train=train)
    # float32 through 3 propagation steps: the two sum in other orders
    assert (got - want).abs().max() <= 2e-5 * want.abs().max()
    assert (want > 0).float().mean() > 0.5


@pytest.mark.parametrize("name", CONFIGS)
def test_train_step_matches_the_port(name):
    from nlspn_eccv20_tpu_torch.config import Config
    from nlspn_eccv20_tpu_torch.train import Engine

    f = fields(name, **SMALL)
    c = load_config(f)
    weights = make_weights(c, 12, "cpu")
    eng = Engine(Config(**f, lr=1e-3, warm_up=False), steps_per_epoch=100, device="cpu")
    eng.init_state(weights)
    rgb, dep, gt = inputs(2)
    batch = {k: v.permute(0, 2, 3, 1).numpy() for k, v in (("rgb", rgb), ("dep", dep), ("gt", gt))}
    loss = float(eng.train_step(eng.put_train_batch(batch))["loss"])
    ref = readings(c, weights, [batch], {"lr": 1e-3, "betas": (0.9, 0.999), "eps": 1e-8})
    assert abs(loss - ref["loss"][0]) <= 1e-6 * ref["loss"][0]
    # Adam's first step moves each element by about lr: compare each leaf's
    # move; an element whose gradient is near 0 may take the other sign
    moved = {n: float((p.detach() - weights[n]).norm()) for n, p in eng.model.named_parameters()}
    floor = np.median(list(ref["change"].values()))
    gaps = [abs(moved[n] - ref["change"][n]) / max(ref["change"][n], floor) for n in ref["change"]]
    assert max(gaps) <= 1e-2
    assert np.median(gaps) <= 1e-4


FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "orbax", "nlspn_eccv20_tpu",
             "nlspn_eccv20_tpu_torch"}


def test_reference_imports_neither_the_port_nor_jax():
    code = ("import sys, gpubench.reference.model, gpubench.reference.train, "
            "gpubench.reference.weights, gpubench.roofline, gpubench.roofline.flops, "
            "gpubench.check, gpubench.generator; "
            "print(' '.join(sorted({m.split('.')[0] for m in sys.modules})))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, check=True).stdout.split()
    assert not FORBIDDEN & set(out)
    folder = os.path.join(ROOT, "gpubench", "reference")
    for fname in os.listdir(folder):
        if fname.endswith(".py"):
            with open(os.path.join(folder, fname)) as fh:
                tree = ast.parse(fh.read())
            names = {a.name for n in ast.walk(tree) if isinstance(n, ast.Import) for a in n.names}
            names |= {n.module for n in ast.walk(tree)
                      if isinstance(n, ast.ImportFrom) and n.module}
            assert not FORBIDDEN & {n.split(".")[0] for n in names}, fname
