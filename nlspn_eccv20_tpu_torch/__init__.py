"""NLSPN depth completion in PyTorch, with hand-written CUDA kernels for Hopper.

A port of ``nlspn_eccv20_tpu`` (JAX). ``serve.Predictor`` serves the model
and ``train.Engine`` trains it, for the fork default, the non-local
propagation (``Config(offset=True)``) and the constant affinity
(``Config(use_GRU=False, prop_impl="pallas")``); the propagation loop
launches hand-written CUDA kernels from ``csrc/``, each with a hand-written
backward. ``ops`` is the op library (DCN v1/v2 and its modules, deformable
PS-RoI pooling, the space-to-depth convs, the op-level propagation and
affinity functions, and the small-output 3x3 conv kernel). Parameter names
are the reference NLSPN ``state_dict`` names, so released checkpoints load
with ``load_state_dict``.
"""

from nlspn_eccv20_tpu_torch.config import Config  # noqa: F401
