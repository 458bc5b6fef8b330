"""Data parallel and width sharding over ``torch.distributed``
(counterpart of ``nlspn_eccv20_tpu/parallel/mesh.py``).

The JAX package runs one program over a ``Mesh(('data', 'space'))``:
parameters replicated, the batch sharded over the data axis and the
image's width over the space axis (``num_spatial_shards``), and XLA adds
the gradient and BatchNorm reductions and, around every conv and stencil
of a sharded width, the halo exchanges. The port runs one process a card
(a "rank"), as the reference ran DDP. ``world = data x space`` ranks, rank
``r`` at ``(d, s) = (r // space, r % space)`` (the JAX
``devices.reshape(-1, num_spatial)`` order): every rank holds the whole
model, reads the images of data shard ``d`` and keeps strip ``s`` of their
columns (``strip_bounds``), launches every kernel on that strip, and the
ranks meet at explicit collectives:

* ``models/common.BatchNorm`` adds every rank's per-channel sums and pixel
  counts in train mode, so that its statistics are the global batch's;
* with width shards the model exchanges, by hand, the halo each conv,
  pool and propagation step reads (``parallel/halo.py``), over the space
  group of the ranks that hold the same images, and the losses and
  metrics add their valid-pixel counts over it;
* ``train.Engine.train_step`` adds the ranks' gradients (and the step's
  loss and metric sums) once a step, after the backward;
* ``train.Engine.eval_step`` sends the per-image rows of each data shard
  (its space rank 0's) to rank 0; ``Engine.whole`` gathers an output's
  strips where the whole images are needed.

``ops/pallas/shard.py`` has no counterpart: it makes the JAX package's
Pallas kernels run on each device's shard of the data mesh, and here each
rank launches every kernel on its own shard anyway. One process cannot
width-shard: it refuses ``num_spatial_shards > 1`` with the JAX
``make_mesh``'s words.

A process group comes from the launcher's environment
(``maybe_initialize_distributed``): torchrun's ``RANK``, ``WORLD_SIZE``,
``LOCAL_RANK``, ``MASTER_ADDR`` and ``MASTER_PORT``, else SLURM's or Open
MPI's rank variables beside ``MASTER_ADDR``/``MASTER_PORT``. On the card
the backend is NCCL, on the CPU (``platform='cpu'``) gloo; a caller may name
one (``chip_smoke.py`` puts two gloo ranks on one card). Without those
variables nothing is initialised and everything here acts as one rank.

Usage:
    torchrun --nproc_per_node 8 -m nlspn_eccv20_tpu_torch.main ...
    torchrun --nproc_per_node 4 -m nlspn_eccv20_tpu_torch.main \\
        --num_spatial_shards 2 ...          # 2 data shards x 2 strips
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from nlspn_eccv20_tpu_torch.parallel.halo import Strips

STRIP_ALIGN = 8   # the model's total stride: conv3, conv4, conv5 each stride 2


@dataclass(frozen=True)
class Mesh:
    """``size`` data shards of ``space`` strips each, and the device this
    process's model and batches sit on. ``strips`` is this rank's place on
    the space axis (None without width shards); ``data_group`` the process
    group of the ranks that hold the same strip of the other data shards'
    images (None without width shards)."""

    size: int
    device: Optional[torch.device] = None
    space: int = 1
    strips: Optional[Strips] = None
    data_group: Any = field(default=None, compare=False, repr=False)

    @property
    def space_index(self) -> int:
        return 0 if self.strips is None else self.strips.index


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


# The subgroups of a world, made once a process group: dist.new_group is a
# collective every rank calls in the same order, and its groups live as long
# as the process group does.
_SUBGROUPS: Dict[Tuple[int, int], tuple] = {}


def _subgroups(world: int, space: int):
    """(one group a data index: its space ranks, one group a space index:
    its data ranks), made in the same order on every rank."""
    default = dist.group.WORLD
    made = _SUBGROUPS.get((world, space))
    if made is None or made[0] is not default:
        by_data = [dist.new_group(list(range(d * space, (d + 1) * space)))
                   for d in range(world // space)]
        by_space = [dist.new_group(list(range(s, world, space))) for s in range(space)]
        made = _SUBGROUPS[(world, space)] = (default, by_data, by_space)
    return made[1], made[2]


def make_mesh(num_devices: int = 0, num_spatial: int = 1,
              device=None) -> Mesh:
    """The data and space axes over the process group's ranks.
    ``num_spatial`` must divide the ranks (in one process any count above 1
    raises, as the JAX ``make_mesh`` raises for one device);
    ``num_devices`` (the config's ``num_data_shards``) is resolved against
    ``world // num_spatial``: 0 means all of them; one process takes any
    count, as the JAX mesh cuts its device list to what there is; with more
    ranks only their number is accepted."""
    world = world_size()
    if num_spatial > 1 and world % num_spatial:
        raise ValueError(f"{world} devices not divisible by num_spatial_shards={num_spatial}")
    data = world // num_spatial
    if world > 1 and num_devices not in (0, data):
        raise ValueError(f"num_data_shards={num_devices} with {world} ranks: "
                         f"give 0 or {data} (one rank a card, "
                         f"num_spatial_shards={num_spatial} of them a data shard)")
    device = None if device is None else torch.device(device)
    if num_spatial == 1:
        return Mesh(data, device)
    by_data, by_space = _subgroups(world, num_spatial)
    r = rank()
    return Mesh(data, device, num_spatial,
                Strips(r % num_spatial, num_spatial, by_data[r // num_spatial]),
                by_space[r % num_spatial])


def check_batch(batch_size: int, mesh: Mesh) -> None:
    """The reference's rule: the global batch divides over the data shards."""
    if batch_size % mesh.size:
        raise ValueError(f"batch_size={batch_size} does not divide over the "
                         f"{mesh.size} ranks")


def strip_bounds(width: int, count: int) -> List[int]:
    """The columns where the ``count`` strips of a ``width``-column image
    begin, and ``width``: boundary ``r`` is ``8 * floor(r * width / (8 *
    count) + 1/2)``, a multiple of the model's total stride, so that every
    stride-2 layer keeps its phase and every strip has whole columns at 1/2,
    1/4 and 1/8 (only the last strip is ragged). A strip narrower than 8
    columns raises (16 columns over 4 would give 8, 0, 8, 0)."""
    q = STRIP_ALIGN
    bounds = ([0] + [q * ((2 * r * width + q * count) // (2 * q * count))
                     for r in range(1, count)] + [width])
    for s in range(count):
        n = bounds[s + 1] - bounds[s]
        if n < q:
            raise ValueError(
                f"{width} columns over num_spatial_shards={count}: strip {s} would "
                f"hold {max(n, 0)} columns; width sharding needs at least {q} a strip")
    return bounds


def shard_batch(mesh: Mesh, batch: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    """This rank's shard (the loader reads only its data shard's images)
    as NCHW float32 tensors on the rank's device: rgb, dep and gt of NHWC
    arrays, cut to this rank's strip of columns under width shards."""
    cols = slice(None)
    if mesh.strips is not None:
        bounds = strip_bounds(batch["rgb"].shape[2], mesh.space)
        cols = slice(bounds[mesh.space_index], bounds[mesh.space_index + 1])
    return {k: torch.from_numpy(np.ascontiguousarray(batch[k][:, :, cols], np.float32))
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


def gather_to_main(obj, group=None) -> Optional[list]:
    """Each rank's ``obj`` (picklable, on the host) in a list on rank 0,
    in rank order; None on the other ranks. With ``group`` (which holds
    rank 0) only its ranks call it and send."""
    out = [None] * dist.get_world_size(group) if is_main_process() else None
    dist.gather_object(obj, out, dst=0, group=group)
    return out
