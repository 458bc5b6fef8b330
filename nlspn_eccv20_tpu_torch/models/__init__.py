"""Model registry (counterpart of ``nlspn_eccv20_tpu/models/__init__.py``)."""

from __future__ import annotations

from nlspn_eccv20_tpu_torch.device import resolve_device
from nlspn_eccv20_tpu_torch.models.nlspn import NLSPNModel  # noqa: F401

_MODELS = {"NLSPN": NLSPNModel}


def get_model(cfg, device=None):
    """The configured model on ``device`` (the CUDA card unless the caller
    passes ``device="cpu"``), in eval mode."""
    if cfg.model_name not in _MODELS:
        raise NotImplementedError(f"unknown model {cfg.model_name}")
    device = resolve_device(device)
    return _MODELS[cfg.model_name](cfg).to(device).eval()
