"""Hand-written CUDA kernels (sources in ``nlspn_eccv20_tpu_torch/csrc``),
each with its plain PyTorch version and launch counter."""
