"""Build the NYU Depth V2 split JSON from the HDF5 tree (counterpart of
``nlspn_eccv20_tpu/tools/generate_json_nyu.py``: the same JSON for the same
tree and seed).

As the reference's ``utils/generate_json_NYUDepthV2.py``: a train/val split
of the shuffled train files with 5% validation, test from val/official.
The reference reads CSPN's CSV lists; this tool walks the HDF5 tree itself
(train/<scene>/*.h5, val/official/*.h5).

Usage:
  python -m nlspn_eccv20_tpu_torch.tools.generate_json_nyu \
      --path_root /data/NYUDepthV2_HDF5 --path_out nyu.json
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import random


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--path_root", required=True)
    ap.add_argument("--path_out", required=True)
    ap.add_argument("--val_ratio", type=float, default=0.05)
    ap.add_argument("--num_train", type=int, default=int(1e10))
    ap.add_argument("--num_val", type=int, default=int(1e10))
    ap.add_argument("--num_test", type=int, default=int(1e10))
    ap.add_argument("--seed", type=int, default=7240)
    args = ap.parse_args(argv)

    random.seed(args.seed)

    train_all = sorted(glob.glob(os.path.join(args.path_root, "train", "*", "*.h5")))
    test_all = sorted(glob.glob(os.path.join(args.path_root, "val", "official", "*.h5")))
    assert train_all, f"no h5 files under {args.path_root}/train"

    rel = lambda p: os.path.relpath(p, args.path_root)
    train_all = [{"filename": rel(p)} for p in train_all]
    random.shuffle(train_all)
    n_val = int(len(train_all) * args.val_ratio)
    val = train_all[:n_val][:args.num_val]
    train = train_all[n_val:][:args.num_train]
    test = [{"filename": rel(p)} for p in test_all][:args.num_test]

    with open(args.path_out, "w") as f:
        json.dump({"train": train, "val": val, "test": test}, f, indent=2)
    print({"train": len(train), "val": len(val), "test": len(test)})


if __name__ == "__main__":
    main()
