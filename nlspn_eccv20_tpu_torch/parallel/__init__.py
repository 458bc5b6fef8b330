"""Data parallel and width sharding over ``torch.distributed``: ranks, the
process group, the placement of batches and weights and the halo
exchanges between strips (counterpart of ``nlspn_eccv20_tpu/parallel``)."""

from nlspn_eccv20_tpu_torch.parallel.mesh import (  # noqa: F401
    Mesh,
    is_main_process,
    make_mesh,
    maybe_initialize_distributed,
    replicate,
    shard_batch,
    strip_bounds,
)
