"""The PyTorch port's Predictor held against the JAX package's, on the CPU.

Same weights (seeded, every leaf non-zero) and the same requests: one uint8
request and a ragged batch of two, both padded to the 32-pixel bucket.
"""

import dataclasses

import numpy as np
import pytest

from nlspn_eccv20_tpu.serve import Predictor as JaxPredictor
from nlspn_eccv20_tpu_torch.config import Config
from nlspn_eccv20_tpu_torch.serve import Predictor, _round_up
from nlspn_eccv20_tpu_torch.utils.weights import from_jax_variables
from test_torch_model import TINY, jax_model_and_variables

TOL = 2e-4


@pytest.fixture(scope="module")
def predictors():
    jcfg, _, variables = jax_model_and_variables(TINY, 32, 32)
    cfg = Config(**dataclasses.asdict(jcfg))
    port = Predictor(cfg, state_dict=from_jax_variables(variables, cfg),
                     device="cpu")
    return port, JaxPredictor(jcfg, variables=variables)


def requests(shapes, seed=0):
    rng = np.random.default_rng(seed)
    rgbs = [rng.integers(0, 256, (h, w, 3), dtype=np.uint8) for h, w in shapes]
    deps = [((rng.random((h, w)) > 0.9) * rng.uniform(0.5, 5.0, (h, w))
             ).astype(np.float32) for h, w in shapes]
    return rgbs, deps


def assert_close(port, ref):
    assert port.shape == ref.shape
    err = np.max(np.abs(port - ref))
    assert err / max(np.max(np.abs(ref)), 1.0) < TOL, err


def test_single_uint8_request_matches_jax(predictors):
    port, ref = predictors
    (rgb,), (dep,) = requests([(30, 41)])
    out = port.predict(rgb, dep)
    assert out.shape == (30, 41) and out.dtype == np.float32
    assert_close(out, ref.predict(rgb, dep))
    m = dep > 0
    assert np.array_equal(out[m], dep[m])


def test_ragged_batch_matches_jax(predictors):
    port, ref = predictors
    rgbs, deps = requests([(32, 32), (27, 58)], seed=1)
    outs = port.predict_batch(rgbs, deps)
    refs = ref.predict_batch(rgbs, deps)
    assert [o.shape for o in outs] == [(32, 32), (27, 58)]
    for o, r in zip(outs, refs):
        assert_close(o, r)


def test_predict_leaves_global_cudnn_flags(predictors):
    """Serving picks cuDNN's benchmark mode for its own calls only."""
    import torch
    cudnn = torch.backends.cudnn
    before = (cudnn.enabled, cudnn.benchmark, cudnn.deterministic,
              cudnn.allow_tf32)
    predictors[0].predict(*[r[0] for r in requests([(16, 16)], seed=2)])
    assert (cudnn.enabled, cudnn.benchmark, cudnn.deterministic,
            cudnn.allow_tf32) == before


def test_benchmark_needs_the_card(predictors):
    with pytest.raises(RuntimeError):
        predictors[0].benchmark(32, 32, calls=1)


def test_round_up():
    assert _round_up(228, 32) == 256
    assert _round_up(304, 32) == 320
    assert _round_up(256, 32) == 256
