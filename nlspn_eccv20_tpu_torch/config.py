"""Configuration for the PyTorch/CUDA port of NLSPN.

A copy of the JAX package's ``Config`` dataclass with the same field names,
defaults and validation, so that one dict builds both packages' configs:
``Config(**dataclasses.asdict(jax_cfg))``. Fields that only steer the JAX
package's backends (``platform``, ``prop_loop``, ``fused_kernels``,
``compile_cache*``) are kept for that round trip and are not read by the
port. ``prop_impl`` is read for one route only: ``'pallas'`` with
``use_GRU=False`` runs the whole propagation loop as one ``prop_loop``
kernel, as it takes the JAX package to its whole-loop kernel; ``'auto'``
and ``'xla'`` keep a ``prop_step`` launch per step. The CLI parser is not
ported yet.
"""

from __future__ import annotations

import dataclasses
import json
import time
from dataclasses import dataclass
from typing import List, Optional, Tuple


@dataclass
class Config:
    # ----- Dataset -----
    dir_data: str = "/data/NYUDepthV2_HDF5"
    data_name: str = "NYU"                   # NYU | KITTIDC | Synthetic
    split_json: str = "data_json/nyu.json"
    patch_height: int = 228
    patch_width: int = 304
    top_crop: int = 0

    # ----- Hardware / runtime -----
    seed: int = 7240
    num_threads: int = 4
    platform: Optional[str] = None
    num_data_shards: int = 0
    num_spatial_shards: int = 1

    # ----- Network -----
    model_name: str = "NLSPN"
    affinity_gamma: float = 0.5
    legacy: bool = False

    # ----- Training -----
    loss: str = "1.0*L1+1.0*L2"
    pretrain: Optional[str] = None
    resume: bool = False
    test_only: bool = False
    epochs: int = 20
    batch_size: int = 12
    max_depth: float = 10.0
    augment: bool = True
    num_sample: int = 500
    test_crop: bool = False
    test_pipeline: bool = False

    # ----- Mixed precision ('f32' only in the port so far) -----
    precision: str = "f32"

    # ----- Summary -----
    num_summary: int = 4

    # ----- Optimizer -----
    decay: str = "10,15,20"
    gamma: str = "1.0,0.2,0.04"
    optimizer: str = "ADAM"                  # SGD | ADAM | RMSprop
    momentum: float = 0.9
    betas: Tuple[float, float] = (0.9, 0.999)
    epsilon: float = 1e-8
    weight_decay: float = 0.0
    warm_up: bool = True
    lr: float = 0.001

    # ----- Logs -----
    save: str = "trial"
    save_dir: str = ""
    save_full: bool = True
    save_image: bool = False
    save_result_only: bool = False
    experiments_dir: str = "experiments"

    # ----- GRU / model options (fork defaults) -----
    GRU_hidden_dim: int = 128
    GRU_input_dim: int = 128
    use_GRU: bool = True
    use_S2D: bool = True
    zero_init_aff: bool = True
    network: str = "resnet18"                # resnet18 | resnet34
    from_scratch: bool = False
    dir_pretrain_backbone: str = "pretrained"
    prop_time: int = 12
    preserve_input: bool = True
    always_clip: bool = False
    prop_kernel: int = 3
    affinity: str = "TGASS"                  # AS | ASS | TC | TGASS
    conf_prop: bool = True
    offset: bool = False
    offset_window: int = 4
    offset_neighbor_loop: str = "unroll"
    prop_impl: str = "auto"
    prop_loop: str = "unroll"
    fused_kernels: str = "auto"

    # ----- Profiling -----
    profile: bool = False
    profile_dir: str = ""

    # ----- Compilation cache (JAX package only) -----
    compile_cache: bool = True
    compile_cache_dir: str = ""

    # ------------------------------------------------------------------
    def __post_init__(self):
        if self.prop_kernel % 2 != 1 or self.prop_kernel < 1:
            raise ValueError(f"only odd prop_kernel >= 1 supported, got {self.prop_kernel}")
        if self.affinity not in ("AS", "ASS", "TC", "TGASS"):
            raise ValueError(f"unknown affinity {self.affinity!r} (AS|ASS|TC|TGASS)")
        if self.prop_time < 0:
            raise ValueError(f"prop_time must be >= 0, got {self.prop_time}")
        if self.num_sample < 0:
            raise ValueError(f"num_sample must be >= 0, got {self.num_sample}")
        if self.batch_size < 1:
            raise ValueError(f"batch_size must be >= 1, got {self.batch_size}")
        if self.optimizer.upper() not in ("SGD", "ADAM", "RMSPROP"):
            raise ValueError(f"unknown optimizer {self.optimizer!r}")
        if self.network not in ("resnet18", "resnet34"):
            raise ValueError(f"unknown network {self.network!r}")
        if self.precision not in ("f32", "bf16"):
            raise ValueError(f"unknown precision {self.precision!r} (f32|bf16)")
        if self.offset_window < 0:
            raise ValueError(
                f"offset_window must be >= 0, got {self.offset_window}")
        if self.offset_neighbor_loop not in ("unroll", "scan"):
            raise ValueError(
                f"unknown offset_neighbor_loop {self.offset_neighbor_loop!r}")
        if self.prop_impl not in ("auto", "xla", "pallas"):
            raise ValueError(f"unknown prop_impl {self.prop_impl!r}")
        if self.prop_loop not in ("unroll", "scan"):
            raise ValueError(f"unknown prop_loop {self.prop_loop!r}")
        if self.fused_kernels not in ("auto", "on", "off"):
            raise ValueError(f"unknown fused_kernels {self.fused_kernels!r}")
        if self.num_spatial_shards < 1:
            raise ValueError(
                f"num_spatial_shards must be >= 1, got {self.num_spatial_shards}")
        if self.num_spatial_shards > 1:
            if self.fused_kernels == "on":
                raise ValueError(
                    "fused_kernels='on' is incompatible with spatial "
                    "sharding (num_spatial_shards > 1); use 'auto' or 'off'")
            if self.prop_impl == "pallas":
                raise ValueError(
                    "prop_impl='pallas' is incompatible with spatial "
                    "sharding (num_spatial_shards > 1); use 'auto' or 'xla'")

    @property
    def num_neighbors(self) -> int:
        return self.prop_kernel * self.prop_kernel - 1

    def finalize(self) -> "Config":
        """Compute derived fields; call once after parsing."""
        if not self.save_dir:
            ts = time.strftime("%y%m%d_%H%M%S_")
            self.save_dir = f"{self.experiments_dir}/{ts}{self.save}"
        if not self.profile_dir:
            self.profile_dir = f"{self.save_dir}/profile"
        return self

    def decay_schedule(self) -> Tuple[List[int], List[float]]:
        decay = [int(v) for v in str(self.decay).replace("'", "").replace('"', "").split(",")]
        gamma = [float(v) for v in str(self.gamma).replace("'", "").replace('"', "").split(",")]
        if len(decay) != len(gamma):
            raise ValueError("decay and gamma must have same length")
        return decay, gamma

    def lr_factor(self, epoch: int) -> float:
        """Piecewise-constant LR factor: first decay boundary with epoch < d wins."""
        decay, gamma = self.decay_schedule()
        for d, g in zip(decay, gamma):
            if epoch < d:
                return g
        return gamma[-1]

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2, default=str)

    @classmethod
    def from_json(cls, text: str) -> "Config":
        raw = json.loads(text)
        known = {f.name for f in dataclasses.fields(cls)}
        kwargs = {k: v for k, v in raw.items() if k in known}
        if "betas" in kwargs and isinstance(kwargs["betas"], list):
            kwargs["betas"] = tuple(kwargs["betas"])
        return cls(**kwargs)

    def replace(self, **kwargs) -> "Config":
        return dataclasses.replace(self, **kwargs)
