"""Copy KITTI raw RGB / oxts / calib into the KITTI DC tree (counterpart of
``nlspn_eccv20_tpu/tools/prepare_kitti_dc.py``: the same copies).

As the reference's ``utils/prepare_KITTI_DC.py``: for each train/val
sequence of the depth-completion download, copy the image_02/image_03
frames, oxts and the three calib files of the matching KITTI raw sequence,
so that the DC tree stands alone.

Usage:
  python -m nlspn_eccv20_tpu_torch.tools.prepare_kitti_dc \
      --path_dc /data/KITTIDepthCompletion --path_raw /data/KITTIRaw
"""

from __future__ import annotations

import argparse
import glob
import os
import shutil


CALIB_FILES = ("calib_cam_to_cam.txt", "calib_imu_to_velo.txt",
               "calib_velo_to_cam.txt")


def prepare_split(path_dc: str, path_raw: str, split: str, dry_run: bool = False):
    seqs = sorted(glob.glob(os.path.join(path_dc, split, "*_sync")))
    copied = 0
    for seq in seqs:
        name = os.path.basename(seq)
        date = name[:10]
        raw_seq = os.path.join(path_raw, date, name)
        if not os.path.isdir(raw_seq):
            print(f"missing raw sequence: {raw_seq}")
            continue
        for sub in ("image_02", "image_03", "oxts"):
            src = os.path.join(raw_seq, sub)
            dst = os.path.join(seq, sub)
            if os.path.isdir(src) and not os.path.isdir(dst):
                if not dry_run:
                    shutil.copytree(src, dst)
                copied += 1
        # the calib files go into each sequence dir, the reference's
        # layout, so that trees prepared by either tool read the same
        for cf in CALIB_FILES:
            src = os.path.join(path_raw, date, cf)
            dst = os.path.join(seq, cf)
            if os.path.isfile(src) and not os.path.isfile(dst):
                if not dry_run:
                    shutil.copy2(src, dst)
                copied += 1
    return copied


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--path_dc", required=True)
    ap.add_argument("--path_raw", required=True)
    ap.add_argument("--dry_run", action="store_true")
    args = ap.parse_args(argv)
    n = 0
    for split in ("train", "val"):
        n += prepare_split(args.path_dc, args.path_raw, split, args.dry_run)
    print(f"copied {n} items")


if __name__ == "__main__":
    main()
