"""One bf16 train step of the port's default configuration against the JAX
bf16 train step with both fused kernels in interpret mode, from the same
weights, at the bars that ``tests/test_torch_bf16_train.py`` sets out
(a file of its own so that each stays under a minute on one worker: the
JAX step's compilation takes about half of that)."""

import pytest

from test_torch_bf16_train import check_train_step


@pytest.mark.parametrize("name", ["default"])
def test_bf16_train_step_matches_jax_bf16_train_step(name):
    check_train_step(name)
