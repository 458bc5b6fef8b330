"""NLSPN depth completion in PyTorch, with hand-written CUDA kernels for Hopper.

A port of ``nlspn_eccv20_tpu`` (JAX). This first slice serves the
fork-default model: ``serve.Predictor`` runs the network, whose propagation
loop launches three CUDA kernels from ``csrc/`` (the propagation step, the
decode_aff tail and the encode_dep front). Parameter names are the reference
NLSPN ``state_dict`` names, so released checkpoints load with
``load_state_dict``.
"""

from nlspn_eccv20_tpu_torch.config import Config  # noqa: F401
