"""Configuration and command line of the PyTorch/CUDA port of NLSPN.

A copy of the JAX package's ``Config`` dataclass with the same field names,
defaults and validation, so that one dict builds both packages' configs:
``Config(**dataclasses.asdict(jax_cfg))``; ``build_parser`` has the same
flags (with the same ``--name`` / ``--no_name`` pairs), so the same command
line parses to the same fields in both.

``platform`` is read by ``main`` only: ``None`` or ``'gpu'`` runs on the
CUDA card, ``'cpu'`` on the CPU with every kernel's plain version; any
other value raises. Fields that only steer the JAX package's backends
(``prop_loop``, ``fused_kernels``) are kept for the round trip and are not
read by the port. ``compile_cache`` and ``compile_cache_dir`` place the
kernels' builds (``utils/compile_cache.py``). ``num_data_shards`` is
resolved against the ranks of a process group (``parallel/mesh.py``): 0 or
their number over ``num_spatial_shards``; one process accepts any count, as
the JAX mesh does on one device. ``num_spatial_shards > 1`` shards each
image's width over that many ranks (each a strip of columns, the halos
exchanged by hand; ``parallel/halo.py``) for the default model, for
``use_GRU=False`` and for ``offset=True``, in f32 and bf16, through
``train.Engine`` and ``main`` under torchrun; one process refuses it with
the JAX ``make_mesh``'s ``ValueError`` for one device ("1 devices not
divisible by num_spatial_shards=2"); ``serve.Predictor`` does not read it,
as in JAX. ``prop_impl`` is
read for one route only: ``'pallas'`` with ``use_GRU=False`` runs the whole
propagation loop as one ``prop_loop`` kernel, as it takes the JAX package
to its whole-loop kernel; ``'auto'`` and ``'xla'`` keep a ``prop_step``
launch per step. ``precision='bf16'`` serves, tests and trains in bf16, as
the JAX package computes it (``models/nlspn.py`` says where).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
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

    # ----- Mixed precision -----
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

    # ----- Compilation cache (the port: where main builds the kernels) -----
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


def _add_bool_flag(parser: argparse.ArgumentParser, name: str, default: bool,
                   help_: str = ""):
    """--name / --no_name paired flags (e.g. --augment / --no_augment)."""
    group = parser.add_mutually_exclusive_group()
    group.add_argument(f"--{name}", dest=name, action="store_true", help=help_)
    group.add_argument(f"--no_{name}", dest=name, action="store_false")
    parser.set_defaults(**{name: default})


def build_parser() -> argparse.ArgumentParser:
    d = Config()
    p = argparse.ArgumentParser(description="NLSPN on a CUDA card (PyTorch)")

    # Dataset
    p.add_argument("--dir_data", type=str, default=d.dir_data)
    p.add_argument("--data_name", type=str, default=d.data_name,
                   choices=("NYU", "KITTIDC", "Synthetic"))
    p.add_argument("--split_json", type=str, default=d.split_json)
    p.add_argument("--patch_height", type=int, default=d.patch_height)
    p.add_argument("--patch_width", type=int, default=d.patch_width)
    p.add_argument("--top_crop", type=int, default=d.top_crop)

    # Hardware
    p.add_argument("--seed", type=int, default=d.seed)
    p.add_argument("--num_threads", type=int, default=d.num_threads)
    p.add_argument("--platform", type=str, default=d.platform,
                   help="gpu (the CUDA card, the default) or cpu (the plain "
                        "versions of the kernels)")
    p.add_argument("--num_data_shards", type=int, default=d.num_data_shards)
    p.add_argument("--num_spatial_shards", type=int, default=d.num_spatial_shards)

    # Network
    p.add_argument("--model_name", type=str, default=d.model_name, choices=("NLSPN",))
    p.add_argument("--affinity_gamma", type=float, default=d.affinity_gamma)
    p.add_argument("--legacy", action="store_true", default=False)

    # Training
    p.add_argument("--loss", type=str, default=d.loss)
    p.add_argument("--pretrain", type=str, default=None)
    p.add_argument("--resume", action="store_true")
    p.add_argument("--test_only", action="store_true")
    p.add_argument("--epochs", type=int, default=d.epochs)
    p.add_argument("--batch_size", type=int, default=d.batch_size)
    p.add_argument("--max_depth", type=float, default=d.max_depth)
    _add_bool_flag(p, "augment", d.augment)
    p.add_argument("--num_sample", type=int, default=d.num_sample)
    p.add_argument("--test_crop", action="store_true", default=False)
    p.add_argument("--test_pipeline", action="store_true", default=False)
    p.add_argument("--precision", type=str, default=d.precision, choices=("f32", "bf16"))

    # Summary
    p.add_argument("--num_summary", type=int, default=d.num_summary)

    # Optimizer
    p.add_argument("--decay", type=str, default=d.decay)
    p.add_argument("--gamma", type=str, default=d.gamma)
    p.add_argument("--optimizer", type=str, default=d.optimizer,
                   choices=("SGD", "ADAM", "RMSprop"))
    p.add_argument("--momentum", type=float, default=d.momentum)
    p.add_argument("--betas", type=float, nargs=2, default=list(d.betas))
    p.add_argument("--epsilon", type=float, default=d.epsilon)
    p.add_argument("--weight_decay", type=float, default=d.weight_decay)
    _add_bool_flag(p, "warm_up", d.warm_up)
    p.add_argument("--lr", type=float, default=d.lr)

    # Logs
    p.add_argument("--save", type=str, default=d.save)
    p.add_argument("--save_dir", type=str, default="")
    _add_bool_flag(p, "save_full", d.save_full)
    p.add_argument("--save_image", action="store_true", default=False)
    p.add_argument("--save_result_only", action="store_true", default=False)
    p.add_argument("--experiments_dir", type=str, default=d.experiments_dir)

    # GRU / model options
    p.add_argument("--GRU_hidden_dim", type=int, default=d.GRU_hidden_dim)
    p.add_argument("--GRU_input_dim", type=int, default=d.GRU_input_dim)
    _add_bool_flag(p, "use_GRU", d.use_GRU)
    _add_bool_flag(p, "use_S2D", d.use_S2D)
    _add_bool_flag(p, "zero_init_aff", d.zero_init_aff)
    p.add_argument("--network", type=str, default=d.network,
                   choices=("resnet18", "resnet34"))
    p.add_argument("--from_scratch", action="store_true", default=False)
    p.add_argument("--dir_pretrain_backbone", type=str,
                   default=d.dir_pretrain_backbone,
                   help="directory of torchvision {resnet18,resnet34}.pth "
                        "ImageNet weights")
    p.add_argument("--prop_time", type=int, default=d.prop_time)
    _add_bool_flag(p, "preserve_input", d.preserve_input)
    p.add_argument("--always_clip", action="store_true", default=False)
    p.add_argument("--prop_kernel", type=int, default=d.prop_kernel)
    p.add_argument("--affinity", type=str, default=d.affinity,
                   choices=("AS", "ASS", "TC", "TGASS"))
    _add_bool_flag(p, "conf_prop", d.conf_prop)
    p.add_argument("--offset", action="store_true", default=False)
    p.add_argument("--offset_window", type=int, default=d.offset_window)
    p.add_argument("--offset_neighbor_loop", type=str,
                   default=d.offset_neighbor_loop, choices=("unroll", "scan"))
    p.add_argument("--prop_impl", type=str, default=d.prop_impl,
                   choices=("auto", "xla", "pallas"))
    p.add_argument("--prop_loop", type=str, default=d.prop_loop,
                   choices=("unroll", "scan"))
    p.add_argument("--fused_kernels", type=str, default=d.fused_kernels,
                   choices=("auto", "on", "off"))

    # Profiling
    p.add_argument("--profile", action="store_true", default=False)
    p.add_argument("--profile_dir", type=str, default="")
    # Compilation cache (main builds the kernels there; utils/compile_cache.py)
    _add_bool_flag(p, "compile_cache", d.compile_cache)
    p.add_argument("--compile_cache_dir", type=str, default=d.compile_cache_dir)
    return p


def parse_args(argv=None) -> Config:
    ns = build_parser().parse_args(argv)
    known = {f.name for f in dataclasses.fields(Config)}
    kwargs = {k: v for k, v in vars(ns).items() if k in known}
    if isinstance(kwargs.get("betas"), list):
        kwargs["betas"] = tuple(kwargs["betas"])
    return check_args(Config(**kwargs).finalize())


def check_args(cfg: Config) -> Config:
    """The reference's resume rule: with ``--resume --pretrain <experiment
    dir>`` the whole saved config is reloaded from that directory's
    ``args.json``, keeping only test_only, pretrain, dir_data and resume
    from the command line, and training continues in the same directory."""
    if not cfg.resume:
        return cfg
    if not cfg.pretrain:
        raise ValueError("--resume requires --pretrain <experiment dir>")
    path = os.path.join(cfg.pretrain, "args.json")
    if not os.path.exists(path):
        raise FileNotFoundError(f"--resume: no args.json under {cfg.pretrain}")
    with open(path) as f:
        saved = Config.from_json(f.read())
    return saved.replace(
        test_only=cfg.test_only, pretrain=cfg.pretrain,
        dir_data=cfg.dir_data, resume=True,
        save_dir=cfg.pretrain,
    ).finalize()
