"""Build the KITTI Depth Completion split JSON (counterpart of
``nlspn_eccv20_tpu/tools/generate_json_kitti_dc.py``: the same JSON for the
same tree and seed).

As the reference's ``utils/generate_json_KITTI_DC.py``: walk the KITTI DC
tree (train/val sequence dirs, depth_selection for the test split) and
write {train, val, test} entry lists with rgb / depth (sparse) / gt / calib
paths relative to --path_root.

Usage:
  python -m nlspn_eccv20_tpu_torch.tools.generate_json_kitti_dc \
      --path_root /data/KITTIDepthCompletion --path_out kitti_dc.json
  python -m nlspn_eccv20_tpu_torch.tools.generate_json_kitti_dc --test_data \
      --path_root ... --path_out kitti_dc_test.json
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import random


def _entries_for_split(root: str, split: str, max_depth_dirs=("image_02", "image_03")):
    out = []
    base = os.path.join(root, split)
    seqs = sorted(glob.glob(os.path.join(base, "*_sync")))
    for seq in seqs:
        seq_name = os.path.basename(seq)
        date = seq_name[:10]  # e.g. 2011_09_26
        # the reference's layout first (calib inside the sequence dir, as
        # prepare_kitti_dc copies it); the date-level file of older trees
        # after it
        calib = os.path.join(split, seq_name, "calib_cam_to_cam.txt")
        if not os.path.isfile(os.path.join(root, calib)):
            alt = os.path.join(date, "calib_cam_to_cam.txt")
            if os.path.isfile(os.path.join(root, alt)):
                calib = alt
        for cam in max_depth_dirs:
            gt_dir = os.path.join(seq, "proj_depth", "groundtruth", cam)
            dep_dir = os.path.join(seq, "proj_depth", "velodyne_raw", cam)
            rgb_dir = os.path.join(seq, cam, "data")
            if not os.path.isdir(gt_dir):
                continue
            for gt_path in sorted(glob.glob(os.path.join(gt_dir, "*.png"))):
                fn = os.path.basename(gt_path)
                dep_path = os.path.join(dep_dir, fn)
                rgb_path = os.path.join(rgb_dir, fn)
                if not (os.path.exists(dep_path) and os.path.exists(rgb_path)):
                    continue
                out.append({
                    "rgb": os.path.relpath(rgb_path, root),
                    "depth": os.path.relpath(dep_path, root),
                    "gt": os.path.relpath(gt_path, root),
                    "K": calib,
                })
    return out


def _entries_for_selection(root: str, subdir: str):
    """depth_selection val_selection_cropped / test_depth_completion_anonymous."""
    base = os.path.join(root, "depth_selection", subdir)
    rgbs = sorted(glob.glob(os.path.join(base, "image", "*.png")))
    out = []
    for rgb in rgbs:
        fn = os.path.basename(rgb)
        dep = os.path.join(base, "velodyne_raw", fn.replace("image", "velodyne_raw"))
        gt = os.path.join(base, "groundtruth_depth", fn.replace("image", "groundtruth_depth"))
        kf = os.path.join(base, "intrinsics", fn.replace(".png", ".txt"))
        if not os.path.exists(dep):
            dep = os.path.join(base, "velodyne_raw", fn)
        if not os.path.exists(gt):
            gt = dep  # anonymous test split has no gt; reference points gt at sparse
        if not os.path.exists(kf):
            kf = os.path.join(base, "intrinsics", fn[:-4] + ".txt")
        out.append({
            "rgb": os.path.relpath(rgb, root),
            "depth": os.path.relpath(dep, root),
            "gt": os.path.relpath(gt, root),
            "K": os.path.relpath(kf, root),
        })
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--path_root", required=True)
    ap.add_argument("--path_out", required=True)
    ap.add_argument("--test_data", action="store_true",
                    help="build the online-test json (no gt)")
    ap.add_argument("--num_train", type=int, default=int(1e10))
    ap.add_argument("--num_val", type=int, default=int(1e10))
    ap.add_argument("--num_test", type=int, default=int(1e10))
    ap.add_argument("--seed", type=int, default=7240)
    args = ap.parse_args(argv)

    random.seed(args.seed)
    if args.test_data:
        # the online-test JSON has only the 'test' key, as the reference's
        # (cf. data_json/kitti_dc_test.json)
        test = _entries_for_selection(args.path_root,
                                      "test_depth_completion_anonymous")
        data = {"test": test[:args.num_test]}
    else:
        train = _entries_for_split(args.path_root, "train")
        val = _entries_for_split(args.path_root, "val")
        test = _entries_for_selection(args.path_root, "val_selection_cropped")
        random.shuffle(train)
        data = {"train": train[:args.num_train], "val": val[:args.num_val],
                "test": test[:args.num_test]}

    with open(args.path_out, "w") as f:
        json.dump(data, f, indent=2)
    print({k: len(v) for k, v in data.items()})


if __name__ == "__main__":
    main()
