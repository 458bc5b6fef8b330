"""Real-data readiness preflight: check a run's inputs before it takes a
card (counterpart of ``nlspn_eccv20_tpu/preflight.py``: the same checks and
the same report).

A bad --dir_data, a missing split JSON or an absent ImageNet backbone would
otherwise surface minutes into a run (or silently train from scratch). This
module checks them all first and prints the resolved recipe:

    python -m nlspn_eccv20_tpu_torch.preflight --dir_data /data/NYUDepthV2_HDF5 \
        --data_name NYU --split_json data_json/nyu.json ...

(the same command line as ``main``; add --deep to stat every referenced
file instead of a sample of each split). Exit code 0 = ready (warnings
allowed), 1 = at least one FAIL. Recipes: docs/RUNBOOK.md.

Checks:
  * split JSON resolves, parses, has the splits the run needs, and its
    entries carry the per-dataset schema keys
    (NYU: {"filename"}; KITTI DC: {"rgb", "depth", "gt"} (+"K" for test))
  * --dir_data exists and the referenced files exist (sampled or --deep)
  * ImageNet backbone file {dir_pretrain_backbone}/{network}.pth, with the
    same severity as the train path (train.init_backbone_pretrained): FAIL
    for an explicit dir, WARN for the default dir, skipped under
    --from_scratch or a --resume with an existing checkpoint
  * --pretrain checkpoint exists (a torch .pt file, or an experiment
    directory with ``ckpt/model_<epoch>.pt``; the JAX package's Orbax
    directories cannot be read here and FAIL)
  * save_dir / experiments_dir is writable
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass, field
from typing import List, Optional

from nlspn_eccv20_tpu_torch.config import Config

OK, WARN, FAIL = "ok", "WARN", "FAIL"

# splits each run phase iterates (main.train: train+val then test;
# main.test: test only)
_SCHEMA = {
    "NYU": {"filename"},
    "KITTIDC": {"rgb", "depth", "gt"},
}


@dataclass
class Check:
    name: str
    status: str
    detail: str = ""


@dataclass
class Report:
    checks: List[Check] = field(default_factory=list)

    def add(self, name: str, status: str, detail: str = "") -> None:
        self.checks.append(Check(name, status, detail))

    @property
    def ok(self) -> bool:
        return all(c.status != FAIL for c in self.checks)

    def render(self) -> str:
        lines = []
        for c in self.checks:
            mark = {OK: "  ok  ", WARN: " WARN ", FAIL: " FAIL "}[c.status]
            lines.append(f"[{mark}] {c.name}" +
                         (f": {c.detail}" if c.detail else ""))
        return "\n".join(lines)


def _needed_splits(cfg: Config) -> List[str]:
    return ["test"] if cfg.test_only else ["train", "val", "test"]


def _entry_paths(data_name: str, entry: dict) -> List[str]:
    if data_name == "NYU":
        return [entry["filename"]]
    return [entry[k] for k in ("rgb", "depth", "gt", "K") if k in entry]


def check_split_json(cfg: Config, report: Report) -> Optional[dict]:
    from nlspn_eccv20_tpu_torch.data import resolve_split_json

    path = resolve_split_json(cfg.split_json)
    if not os.path.isfile(path):
        report.add("split_json", FAIL, f"not found: {cfg.split_json} "
                   f"(resolved {path}); vendored splits live in data_json/")
        return None
    try:
        with open(path) as f:
            splits = json.load(f)
    except (json.JSONDecodeError, UnicodeDecodeError) as e:
        report.add("split_json", FAIL, f"{path} is not valid JSON: {e}")
        return None
    missing = [s for s in _needed_splits(cfg) if s not in splits]
    if missing:
        report.add("split_json", FAIL,
                   f"{path} lacks split(s) {missing} (has "
                   f"{sorted(splits)}); a test-split-only JSON (e.g. "
                   f"kitti_dc_test.json) needs --test_only")
        return None
    empty = [s for s in _needed_splits(cfg) if not splits[s]]
    if empty:
        report.add("split_json", FAIL, f"{path}: empty split(s) {empty}")
        return None
    schema = _SCHEMA.get(cfg.data_name)
    if schema:
        for s in _needed_splits(cfg):
            keys = set(splits[s][0])
            if not schema <= keys:
                report.add("split_json", FAIL,
                           f"{path}[{s}][0] keys {sorted(keys)} lack "
                           f"{sorted(schema - keys)} (expected "
                           f"{cfg.data_name} schema)")
                return None
    sizes = {s: len(splits[s]) for s in _needed_splits(cfg)}
    report.add("split_json", OK, f"{path} {sizes}")
    return splits


def check_data_tree(cfg: Config, splits: Optional[dict], report: Report,
                    deep: bool = False) -> None:
    if cfg.data_name == "Synthetic":
        report.add("dir_data", OK, "synthetic dataset, no files needed")
        return
    if not os.path.isdir(cfg.dir_data):
        report.add("dir_data", FAIL, f"not a directory: {cfg.dir_data}")
        return
    report.add("dir_data", OK, cfg.dir_data)
    if splits is None:
        return
    for s in _needed_splits(cfg):
        entries = splits[s]
        probe = entries if deep else (
            entries[:1] + entries[len(entries) // 2:len(entries) // 2 + 1]
            + entries[-1:])
        missing = []
        for e in probe:
            for rel in _entry_paths(cfg.data_name, e):
                if not os.path.isfile(os.path.join(cfg.dir_data, rel)):
                    missing.append(rel)
        n_checked = sum(len(_entry_paths(cfg.data_name, e)) for e in probe)
        if missing:
            report.add(f"data[{s}]", FAIL,
                       f"{len(missing)}/{n_checked} referenced files "
                       f"missing under {cfg.dir_data}, e.g. {missing[0]}")
        else:
            how = "all" if deep else f"sampled {n_checked}"
            report.add(f"data[{s}]", OK,
                       f"{how} referenced files present ({len(entries)} "
                       f"entries)")


def _latest_epoch_on_disk(save_dir: str) -> Optional[int]:
    """The latest epoch of a port experiment directory, read without
    making anything (a read-only preflight must not)."""
    from nlspn_eccv20_tpu_torch.utils.checkpoint import CheckpointManager

    return CheckpointManager(Config(), save_dir).latest_epoch()


def _holds_orbax(save_dir: str) -> bool:
    ckpt = os.path.join(save_dir, "ckpt")
    return os.path.isdir(ckpt) and any(d.isdigit() for d in os.listdir(ckpt))


def check_backbone(cfg: Config, report: Report) -> None:
    default_pretrain_dir = type(cfg)().dir_pretrain_backbone
    if cfg.from_scratch:
        report.add("backbone", OK, "--from_scratch: no backbone needed")
        return
    if cfg.resume:
        latest = _latest_epoch_on_disk(cfg.save_dir)
        if latest is not None:
            report.add("backbone", OK,
                       f"resume restores epoch {latest}; backbone init "
                       f"skipped (main.py)")
            return
    path = os.path.join(cfg.dir_pretrain_backbone, f"{cfg.network}.pth")
    if os.path.isfile(path):
        report.add("backbone", OK, path)
    elif cfg.dir_pretrain_backbone == default_pretrain_dir:
        report.add("backbone", WARN,
                   f"no {path}; training would start FROM SCRATCH "
                   f"(published accuracy targets assume ImageNet init — "
                   f"reference common.py:21-42). Download the torchvision "
                   f"{cfg.network} state_dict there or pass "
                   f"--from_scratch.")
    else:
        report.add("backbone", FAIL,
                   f"explicit --dir_pretrain_backbone but no {path} "
                   f"(the train path raises for this too)")


def check_pretrain(cfg: Config, report: Report) -> None:
    if not cfg.pretrain:
        if cfg.test_only:
            report.add("pretrain", WARN,
                       "--test_only without --pretrain evaluates random "
                       "weights")
        return
    p = cfg.pretrain
    if os.path.isfile(p):
        report.add("pretrain", OK, f"torch checkpoint file {p}")
    elif os.path.isdir(p):
        # an experiment directory: must hold ckpt/model_<epoch>.pt
        latest = _latest_epoch_on_disk(p)
        if latest is not None:
            report.add("pretrain", OK, f"experiment directory {p} (epoch {latest})")
        elif _holds_orbax(p):
            report.add("pretrain", FAIL,
                       f"{p} holds the JAX package's Orbax checkpoints, which "
                       f"the port cannot read (utils/weights.from_jax_variables "
                       f"converts restored JAX variables)")
        else:
            report.add("pretrain", FAIL,
                       f"{p} holds no restorable checkpoint")
    else:
        report.add("pretrain", FAIL, f"no such file or directory: {p}")


def check_save_dir(cfg: Config, report: Report) -> None:
    target = cfg.save_dir or cfg.experiments_dir
    probe = target
    while probe and not os.path.exists(probe):
        probe = os.path.dirname(probe)
    if not probe:
        probe = "."
    if os.access(probe, os.W_OK):
        report.add("save_dir", OK, f"{target} (writable via {probe})")
    else:
        report.add("save_dir", FAIL, f"{target}: {probe} not writable")


def run_preflight(cfg: Config, deep: bool = False) -> Report:
    report = Report()
    splits = check_split_json(cfg, report)
    check_data_tree(cfg, splits, report, deep=deep)
    check_backbone(cfg, report)
    check_pretrain(cfg, report)
    check_save_dir(cfg, report)
    return report


def _recipe(cfg: Config) -> str:
    phase = "test-only evaluation" if cfg.test_only else (
        f"training {cfg.epochs} epochs @ batch {cfg.batch_size}")
    lines = [
        f"resolved recipe: {cfg.data_name} {phase}",
        f"  patch {cfg.patch_height}x{cfg.patch_width}, max_depth "
        f"{cfg.max_depth}, num_sample {cfg.num_sample}, top_crop "
        f"{cfg.top_crop}",
        f"  model: {cfg.network}, prop_time {cfg.prop_time}, affinity "
        f"{cfg.affinity}, offset {cfg.offset}, precision {cfg.precision}",
        f"  save_dir: {cfg.save_dir}",
        "  expected artifacts: args.json, loss_train.txt, metric_val.txt, "
        "metric_test.txt, ckpt/, events.out.tfevents*",
    ]
    if cfg.save_image and cfg.save_result_only:
        lines.append("  submission PNGs: {save_dir}/test/epoch%04d "
                     "(KITTI online format)")
    return "\n".join(lines)


def main(argv=None) -> int:
    import sys

    from nlspn_eccv20_tpu_torch.config import parse_args

    argv = list(sys.argv[1:] if argv is None else argv)
    deep = "--deep" in argv
    cfg = parse_args([a for a in argv if a != "--deep"])
    report = run_preflight(cfg, deep=deep)
    print(report.render())
    print(_recipe(cfg))
    print("preflight:", "READY" if report.ok else "NOT READY")
    return 0 if report.ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
