"""Data parallel over ``torch.distributed`` (counterpart of
``nlspn_eccv20_tpu/parallel/mesh.py``).

The JAX package runs one program over a ``Mesh(('data',))``: parameters
replicated, the batch sharded over the data axis, and XLA adds the gradient
and BatchNorm reductions. The port runs one process a card (a "rank"), as
the reference ran DDP: every rank holds the whole model, reads its own
shard of each batch and launches every kernel on that shard, and the ranks
meet at explicit collectives:

* ``models/common.BatchNorm`` adds the ranks' per-channel sums in train
  mode, so that its statistics are the global batch's;
* ``train.Engine.train_step`` adds the ranks' gradients (and the step's
  loss and metric sums) once a step, after the backward;
* ``train.Engine.eval_step`` sends every rank's per-image rows to rank 0.

``ops/pallas/shard.py`` has no counterpart: it makes the JAX package's
Pallas kernels run on each device's shard of the data mesh, and here each
rank launches every kernel on its own shard anyway. Width sharding
(``num_spatial_shards > 1``, XLA's halo exchanges around every conv) is not
ported: one process refuses it with the JAX ``make_mesh``'s words, several
ranks with their own.

A process group comes from the launcher's environment
(``maybe_initialize_distributed``): torchrun's ``RANK``, ``WORLD_SIZE``,
``LOCAL_RANK``, ``MASTER_ADDR`` and ``MASTER_PORT``, else SLURM's or Open
MPI's rank variables beside ``MASTER_ADDR``/``MASTER_PORT``. On the card
the backend is NCCL, on the CPU (``platform='cpu'``) gloo; a caller may name
one (``chip_smoke.py`` puts two gloo ranks on one card). Without those
variables nothing is initialised and everything here acts as one rank.

Usage:
    torchrun --nproc_per_node 8 -m nlspn_eccv20_tpu_torch.main ...
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

@dataclass(frozen=True)
class Mesh:
    """The data axis: ``size`` ranks, and the device this process's model
    and batches sit on."""

    size: int
    device: Optional[torch.device] = None


def distributed() -> bool:
    """True inside an initialised process group."""
    return dist.is_available() and dist.is_initialized()


def world_size() -> int:
    return dist.get_world_size() if distributed() else 1


def rank() -> int:
    return dist.get_rank() if distributed() else 0


def local_rank() -> int:
    """This process's rank on its machine (its card's index)."""
    found = cluster_env() if distributed() else None
    return found[2] if found else 0


def is_main_process() -> bool:
    """Rank 0, or the only process: the one that writes logs, summaries,
    checkpoints and test artifacts."""
    return rank() == 0


def _count(env, name: str) -> int:
    value = env.get(name, "")
    return int(value) if value.isdigit() else 0


def cluster_env(env=None) -> Optional[Tuple[int, int, int]]:
    """(rank, world size, local rank) from a launcher's variables, or None
    outside a cluster: torchrun's ``RANK``/``WORLD_SIZE``/``LOCAL_RANK``
    first (a world of one too), then a SLURM job step of more than one task
    (``SLURM_PROCID``, ``SLURM_NTASKS``, ``SLURM_LOCALID``), then Open MPI's
    ``OMPI_COMM_WORLD_*`` with more than one process."""
    env = os.environ if env is None else env
    if "RANK" in env and "WORLD_SIZE" in env:
        r = int(env["RANK"])
        return r, int(env["WORLD_SIZE"]), int(env.get("LOCAL_RANK", r))
    if "SLURM_STEP_NODELIST" in env and _count(env, "SLURM_NTASKS") > 1:
        return (int(env["SLURM_PROCID"]), int(env["SLURM_NTASKS"]),
                int(env.get("SLURM_LOCALID", 0)))
    if _count(env, "OMPI_COMM_WORLD_SIZE") > 1:
        return (int(env["OMPI_COMM_WORLD_RANK"]), int(env["OMPI_COMM_WORLD_SIZE"]),
                int(env.get("OMPI_COMM_WORLD_LOCAL_RANK", 0)))
    return None


def maybe_initialize_distributed(cfg=None, backend: Optional[str] = None) -> bool:
    """Join the process group the launcher's variables describe; returns
    whether this process is in one.

    Outside a cluster (no variables, ``cluster_env``) it does nothing. On
    the card (``cfg.platform`` not ``'cpu'``) it makes ``cuda:LOCAL_RANK``
    the current device before anything else touches CUDA, since the kernels
    launch on the current device; the backend is NCCL there and gloo on
    the CPU, unless ``backend`` names one. A failed initialisation raises:
    a run that meant to be data parallel never trains alone.
    """
    if distributed():
        return True
    found = cluster_env()
    if found is None:
        return False
    r, world, local = found
    on_cpu = cfg is not None and cfg.platform == "cpu"
    if not on_cpu:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is available for rank "
                               f"{r}; pass --platform cpu to run the ranks on the CPU")
        if local >= torch.cuda.device_count():
            raise RuntimeError(f"LOCAL_RANK {local}: this machine has "
                               f"{torch.cuda.device_count()} CUDA devices")
        torch.cuda.set_device(local)
    addr, port = os.environ.get("MASTER_ADDR"), os.environ.get("MASTER_PORT")
    if not (addr and port):
        raise ValueError(f"rank {r} of {world}: set MASTER_ADDR and MASTER_PORT "
                         f"(rank 0's address and a free port)")
    dist.init_process_group(backend or ("gloo" if on_cpu else "nccl"),
                            init_method=f"tcp://{addr}:{port}",
                            rank=r, world_size=world)
    return True


def make_mesh(num_devices: int = 0, num_spatial: int = 1,
              device=None) -> Mesh:
    """The data axis over the process group's ranks. ``num_devices`` (the
    config's ``num_data_shards``) is resolved against the world size: 0
    means every rank; one process takes any count, as the JAX mesh cuts its
    device list to what there is; with more ranks only their number is
    accepted. ``num_spatial > 1`` raises: width sharding is not ported."""
    world = world_size()
    if num_spatial > 1:
        if world == 1:
            raise ValueError(f"1 devices not divisible by num_spatial_shards={num_spatial}")
        raise ValueError(
            f"num_spatial_shards={num_spatial}: width sharding is not ported; "
            f"the {world} ranks run data parallel only (num_spatial_shards=1)")
    if world > 1 and num_devices not in (0, world):
        raise ValueError(f"num_data_shards={num_devices} with {world} ranks: "
                         f"give 0 or {world} (one rank a card)")
    return Mesh(world, None if device is None else torch.device(device))


def check_batch(batch_size: int, mesh: Mesh) -> None:
    """The reference's rule: the global batch divides over the ranks."""
    if batch_size % mesh.size:
        raise ValueError(f"batch_size={batch_size} does not divide over the "
                         f"{mesh.size} ranks")


def shard_batch(mesh: Mesh, batch: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    """This rank's shard (the loader reads only it) as NCHW float32 tensors
    on the rank's device: rgb, dep and gt of NHWC numpy arrays."""
    return {k: torch.from_numpy(np.ascontiguousarray(batch[k], np.float32))
            .to(mesh.device).permute(0, 3, 1, 2).contiguous()
            for k in ("rgb", "dep", "gt") if k in batch}


def replicate(mesh: Mesh, module: torch.nn.Module) -> torch.nn.Module:
    """Every parameter and buffer of ``module`` made equal to rank 0's, in
    place (one broadcast each); nothing happens in one process."""
    if distributed():
        with torch.no_grad():
            for t in list(module.parameters()) + list(module.buffers()):
                dist.broadcast(t.data, src=0)
    return module


class _AllReduceSum(torch.autograd.Function):
    """The sum of a tensor over the ranks; its backward is the sum of the
    ranks' gradients, since every rank's loss reads the sum."""

    @staticmethod
    def forward(ctx, t):
        t = t.clone()
        dist.all_reduce(t)
        return t

    @staticmethod
    def backward(ctx, grad):
        grad = grad.clone()
        dist.all_reduce(grad)
        return grad


def all_reduce_sum(t: torch.Tensor) -> torch.Tensor:
    """``t`` summed over the ranks, differentiable (autograd carries the
    ranks' gradients of the sum back to each rank's ``t``)."""
    return _AllReduceSum.apply(t)


def all_reduce_sum_(tensors: List[torch.Tensor]) -> None:
    """Add each of ``tensors`` (float32, one device) over the ranks, in
    place, with one collective on their concatenation."""
    from torch._utils import _flatten_dense_tensors, _unflatten_dense_tensors

    flat = _flatten_dense_tensors(tensors)
    dist.all_reduce(flat)
    for t, s in zip(tensors, _unflatten_dense_tensors(flat, tensors)):
        t.copy_(s)


def gather_to_main(obj) -> Optional[list]:
    """Each rank's ``obj`` (picklable, on the host) in a list on rank 0,
    in rank order; None on the other ranks."""
    out = [None] * world_size() if is_main_process() else None
    dist.gather_object(obj, out, dst=0)
    return out
