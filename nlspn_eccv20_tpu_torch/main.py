"""Command line of the port: train, validate, checkpoint, then test
(counterpart of ``nlspn_eccv20_tpu/main.py``).

One process on one CUDA card (``--platform cpu`` runs the same on the CPU
with every kernel's plain version), or one process a card under torchrun
(data parallel, ``parallel/mesh.py``): the epoch loop trains and validates,
saves a checkpoint each epoch, then the last weights are tested; with
``--test_only --pretrain <dir or .pt>`` it only tests. ``--test_pipeline``
cuts every loop to one batch. cuDNN runs without TF32, so that
``precision='f32'`` computes in f32. ``--precision bf16`` trains, tests
(and the port serves) in bf16: f32 weights and optimizer, bf16 compute, f32
gradients; its checkpoints hold f32 weights, which an f32 run loads.

Over R ranks in D = R / S data shards of S strips each
(``--num_spatial_shards S``, width sharding) the ranks of data shard d read
its shard of the train set (``batch_size // D`` images a step, the global
batch ``batch_size``) and of the val and test sets (one image a step), and
each keeps its strip of the images' columns. Validation and test count
each sample of the split once: the rows of the shards' padding are dropped
and the others go to rank 0. Only rank 0 writes logs, summaries,
checkpoints and test artifacts (the others' images, and the strips of its
own, reach it first); every rank restores ``--pretrain`` and resumes. The
kernels build once a machine (its local rank 0; the others wait), into
``--compile_cache_dir`` or ``$NLSPN_COMPILE_CACHE`` (default under
``~/.cache``; ``NLSPN_COMPILE_CACHE=0``: ``build/``), see
``utils/compile_cache.py``.

Usage:
  python -m nlspn_eccv20_tpu_torch.main --data_name NYU --dir_data ... \\
      --split_json data_json/nyu.json
  python -m nlspn_eccv20_tpu_torch.main --data_name Synthetic --test_pipeline \\
      --epochs 1
  python -m nlspn_eccv20_tpu_torch.main --platform cpu --data_name Synthetic \\
      --test_pipeline --epochs 1 --batch_size 2 --patch_height 64 \\
      --patch_width 96
  python -m nlspn_eccv20_tpu_torch.main --precision bf16 --data_name Synthetic \\
      --test_pipeline --epochs 1
  python -m nlspn_eccv20_tpu_torch.main --precision bf16 --test_only \\
      --pretrain <experiment dir or .pt> --data_name Synthetic --test_pipeline
  torchrun --nproc_per_node 8 -m nlspn_eccv20_tpu_torch.main --data_name NYU ...
  torchrun --nproc_per_node 2 -m nlspn_eccv20_tpu_torch.main --data_name KITTIDC \\
      --num_spatial_shards 2 ...
"""

from __future__ import annotations

import os
import time

import numpy as np
import torch
import torch.distributed as dist

from nlspn_eccv20_tpu_torch.config import Config, parse_args
from nlspn_eccv20_tpu_torch.data import get_dataset
from nlspn_eccv20_tpu_torch.data.loader import DataLoader
from nlspn_eccv20_tpu_torch.device import resolve_device
from nlspn_eccv20_tpu_torch.metrics import METRIC_NAMES
from nlspn_eccv20_tpu_torch.ops.kernels import build
from nlspn_eccv20_tpu_torch.parallel.mesh import (
    distributed,
    gather_to_main,
    is_main_process,
    local_rank,
    maybe_initialize_distributed,
    rank,
    world_size,
)
from nlspn_eccv20_tpu_torch.summary import get_summary
from nlspn_eccv20_tpu_torch.train import (
    Engine,
    check_offset_telemetry,
    check_shards,
    init_backbone_pretrained,
    load_pretrained_params,
)
from nlspn_eccv20_tpu_torch.utils.backup import backup_source_code
from nlspn_eccv20_tpu_torch.utils.checkpoint import CheckpointManager, load_weights
from nlspn_eccv20_tpu_torch.utils.compile_cache import enable_compilation_cache


def resolve_platform(platform) -> torch.device:
    """``None`` or ``'gpu'``: the CUDA card (raises without one); ``'cpu'``:
    the CPU."""
    if platform in (None, "gpu"):
        return resolve_device(None)
    if platform == "cpu":
        return torch.device("cpu")
    raise ValueError(f"unknown platform {platform!r}: 'gpu' (the CUDA card) "
                     f"or 'cpu'")


def _loader(cfg: Config, dataset, mode: str, batch_size: int = 1) -> DataLoader:
    """Train: this data shard's ``batch_size // shards`` of each global
    batch, shuffled, the last partial batch dropped; val and test:
    ``batch_size`` images a step in order. Either way data shard d (the
    ranks ``d * S`` to ``d * S + S - 1`` of S strips each) reads samples d,
    d + shards, ... of the epoch's order, padded to a multiple of the
    shards; its strips read the same images, augmented alike (the
    augmentation is seeded by the sample)."""
    space = cfg.num_spatial_shards
    n, r = world_size() // space, rank() // space
    if mode == "train":
        return DataLoader(dataset, max(cfg.batch_size // n, 1), shuffle=True,
                          drop_last=True, seed=cfg.seed, num_threads=cfg.num_threads,
                          shard_index=r, num_shards=n)
    return DataLoader(dataset, batch_size, shuffle=False, drop_last=False,
                      seed=cfg.seed, num_threads=cfg.num_threads,
                      shard_index=r, num_shards=n)


def _own_rows(loader: DataLoader, b: int, rows: int) -> int:
    """How many of batch ``b``'s first ``rows`` rows are samples of the
    split, not the padding that evens out the ranks' shards."""
    first = b * loader.batch_size
    return sum(loader.position(first + i) < len(loader.dataset) for i in range(rows))


def _pad_batch(batch, size: int):
    """Pad a partial final batch up to ``size`` by repeating its last
    sample; returns (padded batch, number of real rows). The caller drops
    the padded rows from the loss and metric rows."""
    n = next(iter(batch.values())).shape[0]
    if n == size:
        return batch, n
    pad = size - n
    return {k: np.concatenate([v] + [v[-1:]] * pad, axis=0)
            for k, v in batch.items()}, n


def _restore_pretrain(cfg: Config, model: torch.nn.Module, src: str):
    """Weights from a checkpoint file (reference or port ``.pt/.pth/.tar``)
    or a port experiment directory."""
    return load_pretrained_params(model, load_weights(cfg, src))


def _sync(device: torch.device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _start_profile(cfg: Config, device: torch.device):
    acts = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(cfg.profile_dir, exist_ok=True)
    prof = torch.profiler.profile(activities=acts)
    prof.start()
    return prof


def _resume(cfg: Config, engine: Engine, ckpt: CheckpointManager, latest: int,
            steps_per_epoch: int) -> None:
    """Weights, optimizer and step of epoch ``latest``'s checkpoint."""
    restored = ckpt.restore(latest)
    # the LR schedule finds its epoch boundaries from steps_per_epoch; a
    # changed loader length would shift every warm-up and decay boundary
    saved_spe = restored.get("steps_per_epoch")
    if saved_spe is not None and int(saved_spe) != steps_per_epoch:
        raise ValueError(
            f"resume with steps_per_epoch={steps_per_epoch} but the "
            f"checkpoint was trained with {saved_spe} (dataset or shard count "
            f"changed); the LR schedule would shift. Start a fresh run or "
            f"restore with --pretrain instead.")
    engine.model.load_state_dict(restored["net"])
    if "optimizer" in restored:
        engine.optimizer.load_state_dict(restored["optimizer"])
        engine.step = int(restored["step"])
    else:
        # a weights-only (--no_save_full) checkpoint: a fresh optimizer, the
        # LR schedule resumed by step count, with the reference's notice
        print("State dicts for resume are not saved. Use --save_full argument")
        engine.step = latest * steps_per_epoch


def train(cfg: Config, device=None):
    """The epoch loop, in f32 or bf16 (``cfg.precision``); returns the
    Engine with the last weights."""
    main_proc = is_main_process()
    data_train = get_dataset(cfg, "train")
    data_val = get_dataset(cfg, "val")
    loader_train = _loader(cfg, data_train, "train")

    steps_per_epoch = len(loader_train)
    engine = Engine(cfg, steps_per_epoch=steps_per_epoch, device=device)
    device = engine.device
    loader_val = _loader(cfg, data_val, "val", batch_size=engine.eval_batch_per_host)
    model = engine.init_state()

    ckpt = CheckpointManager(cfg)
    resume_latest = ckpt.latest_epoch() if cfg.resume else None
    start_epoch = 1
    if resume_latest is not None:
        _resume(cfg, engine, ckpt, resume_latest, steps_per_epoch)
        start_epoch = resume_latest + 1
        print(f"resumed from epoch {resume_latest}")
    else:
        # the ImageNet backbone, then a --pretrain restore on top (the
        # reference's order); a resume replaces every weight, so it skips both
        init_backbone_pretrained(cfg, model)
        if cfg.pretrain and not cfg.resume:
            _restore_pretrain(cfg, model, cfg.pretrain)
            print(f"loaded pretrain from {cfg.pretrain}")

    if main_proc:
        os.makedirs(cfg.save_dir, exist_ok=True)
        with open(os.path.join(cfg.save_dir, "args.json"), "w") as f:
            f.write(cfg.to_json())
        backup_source_code(os.path.join(cfg.save_dir, "code"))
        writer_train = get_summary(cfg, "train", engine.loss_fn.loss_name,
                                   METRIC_NAMES)
        writer_val = get_summary(cfg, "val", engine.loss_fn.loss_name, METRIC_NAMES)

    for epoch in range(start_epoch, cfg.epochs + 1):
        loader_train.set_epoch(epoch)
        _sync(device)
        t0 = time.time()
        num_img = 0
        if main_proc:
            print(f"=== Epoch {epoch:4d}/{cfg.epochs} | lr "
                  f"{engine.schedule(engine.step):.6f} | {cfg.save_dir} ===")

        last_train = None
        off_max_epoch = 0.0
        off_warned = False
        prof = None
        for b, batch in enumerate(loader_train):
            if cfg.test_pipeline and b == 1:
                break
            if cfg.profile and main_proc and epoch == start_epoch and b == 1:
                prof = _start_profile(cfg, device)
            placed = engine.put_train_batch(batch)
            aux = engine.train_step(placed)
            num_img += batch["rgb"].shape[0] * engine.mesh.size
            last_train = (placed, aux["output"])
            if main_proc:
                writer_train.add(aux["loss_val"], aux["metric"])
                if "off_max" in aux:
                    # per batch, warned at most once an epoch: an escape in
                    # mid-epoch trains clamped, unlike eval
                    off_b = float(aux["off_max"])
                    off_max_epoch = max(off_max_epoch, off_b)
                    if not off_warned:
                        off_warned = check_offset_telemetry(cfg, off_b, batch_idx=b)
            if prof is not None and b == 3:
                _sync(device)
                prof.stop()
                prof.export_chrome_trace(os.path.join(cfg.profile_dir, "trace.json"))
                print(f"profile trace written to {cfg.profile_dir}")
                prof = None

        _sync(device)
        dt = time.time() - t0
        last_train = engine.whole(last_train) if last_train else (None, None)
        if main_proc:
            off_note = f" | max|offset| {off_max_epoch:.3f}" if cfg.offset else ""
            print(f"train epoch {epoch}: {num_img} images in {dt:.1f}s "
                  f"({num_img / max(dt, 1e-9):.1f} images/s){off_note}")
            if cfg.offset:
                if not off_warned:
                    check_offset_telemetry(cfg, off_max_epoch)
                writer_train.scalar("Etc/max_offset", off_max_epoch, epoch)
            writer_train.update(epoch, *last_train)
            ckpt.save(epoch, engine.checkpoint_state(),
                      full=cfg.save_full or epoch == cfg.epochs)

        last = (None, None)
        for b, batch in enumerate(loader_val):
            if cfg.test_pipeline and b == 1:
                break
            padded, valid = _pad_batch(batch, engine.eval_batch_per_host)
            placed = engine.put_eval_batch(padded)
            res = engine.eval_step(placed, _own_rows(loader_val, b, valid))
            last = (placed, res["output"])
            if main_proc:
                writer_val.add(res["loss_val"], res["metric"])
        if last[0] is not None:
            last = engine.whole(last)
        if main_proc:
            writer_val.update(epoch, *last)

    if main_proc:
        writer_train.close()
        writer_val.close()
    return engine


def _image_of(sample, output, i: int):
    """Host copies of image ``i`` of a batch, as ``Summary.save`` reads
    them: every batched array cut to its row."""
    def row(v):
        if isinstance(v, torch.Tensor) and v.dim() == 4:
            return v[i:i + 1].cpu()
        if isinstance(v, (list, tuple)):
            return [row(t) for t in v]
        return v.cpu() if isinstance(v, torch.Tensor) else v

    return ({k: row(v) for k, v in sample.items()},
            {k: row(v) for k, v in output.items()})


def _save_images(writer, loader: DataLoader, b: int, valid: int, sample, output,
                 engine: Engine):
    """The test artifacts of batch ``b``'s ``valid`` images, each under its
    index in the split. In a process group rank 0 writes them all: the
    other data shards send theirs (each from its first strip, the strips
    gathered first)."""
    first = b * loader.batch_size
    if not distributed():
        for i in range(valid):
            writer.save(0, first + i, sample, output, batch_index=i)
        return
    sample, output = engine.whole((sample, output))
    if engine.mesh.space_index:
        return
    mine = [(loader.position(first + i), _image_of(sample, output, i))
            for i in range(valid)]
    every = gather_to_main(mine, engine.mesh.data_group)
    if writer is not None:
        for idx, (s, o) in sorted((x for r in every for x in r), key=lambda x: x[0]):
            writer.save(0, idx, s, o)


def test(cfg: Config, engine: Engine = None, device=None):
    """Test the weights of ``engine``, or of ``--pretrain`` (else the
    experiment directory); returns the metric means."""
    data_test = get_dataset(cfg, "test")
    if engine is None:
        engine = Engine(cfg, device=device)
        src = cfg.pretrain or cfg.save_dir
        _restore_pretrain(cfg, engine.model, src)
        print(f"loaded checkpoint from {src}")
    device = engine.device

    bsz = engine.eval_batch_per_host
    loader_test = _loader(cfg, data_test, "test", batch_size=bsz)
    writer = get_summary(cfg, "test", None, METRIC_NAMES) if is_main_process() else None
    if writer:
        writer.setup_output_dir(0)

    t_total, n = 0.0, 0
    for b, batch in enumerate(loader_test):
        if cfg.test_pipeline and b == 1:
            break
        padded, valid = _pad_batch(batch, bsz)
        valid = _own_rows(loader_test, b, valid)
        placed = engine.put_eval_batch(padded)
        _sync(device)
        t0 = time.time()
        res = engine.eval_step(placed, valid)
        metric = res["metric"].cpu()
        t1 = time.time()
        if b > 0:  # the first batch picks cuDNN's algorithms
            t_total += t1 - t0
            n += valid
        if writer:
            writer.add(metric=metric)
        if cfg.save_image or cfg.save_result_only:
            _save_images(writer, loader_test, b, valid, placed, res["output"], engine)
    summary = writer.update(0) if writer else {}
    if n:
        print(f"elapsed time : {t_total:.4f} sec, "
              f"average processing time : {t_total / n:.4f} sec")
    if writer:
        writer.close()
    return summary


def _build_kernels():
    """One nvcc per source, all at once, instead of one after another at
    each kernel's first launch; built libraries are reused. In a process
    group the machine's local rank 0 builds while its other ranks wait."""
    failure = None
    if local_rank() == 0:
        try:
            build.build_all()
        except Exception as e:   # raised after the barrier, not before it
            failure = e
    if distributed():
        dist.barrier()
    if failure is not None:
        raise failure
    if local_rank() != 0:
        build.build_all()   # finds every library built


def main(cfg: Config):
    maybe_initialize_distributed(cfg)
    check_shards(cfg)   # before any kernel is built or any data is read
    device = resolve_platform(cfg.platform)
    if distributed():
        # each rank stamped its own save_dir; rank 0's is the run's
        dirs = [cfg.save_dir, cfg.profile_dir]
        dist.broadcast_object_list(dirs, src=0)
        cfg.save_dir, cfg.profile_dir = dirs
        if is_main_process():
            strips = (f", {cfg.num_spatial_shards} strips an image"
                      if cfg.num_spatial_shards > 1 else "")
            print(f"data parallel: {world_size()} ranks{strips} ({dist.get_backend()} on "
                  f"{device.type})")
    if device.type == "cuda":
        if cfg.compile_cache:
            enable_compilation_cache(cfg.compile_cache_dir)
        t0 = time.time()
        _build_kernels()
        print(f"CUDA kernels ready in {time.time() - t0:.1f}s")
    np.random.seed(cfg.seed)
    b = torch.backends.cudnn
    with b.flags(enabled=b.enabled, benchmark=b.benchmark,
                 deterministic=b.deterministic, allow_tf32=False):
        if cfg.test_only:
            return test(cfg, device=device)
        engine = train(cfg, device)
        return test(cfg, engine)


if __name__ == "__main__":
    try:
        main(parse_args())
    finally:
        if distributed():
            dist.destroy_process_group()
