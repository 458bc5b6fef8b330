"""Whether two trees' kernels give the same bits, on the card.

Runs the f32 decode_aff tail K2 (output and y1), the f32 encode_dep front
K3, the f32 GRU-refresh backwards K4 and K5, the op library's f32 K9 and
K9b and its bf16 backward K9b-bf16 on the inputs ``chip_smoke.py`` checks
them on (the
``*_case`` builders, from a seeded generator), at the train step's and the
serving shapes and the odd ones, and either saves
every output (``--save FILE``) or holds them against a saved file
(``--against FILE``), printing one JSON line a case: equal bits, or the
largest difference. To compare a change with its parent, unpack the parent
into a directory the repository ignores, copy this file into its
``tools/``, and run it there with ``--save``, then here with
``--against``, in one call on one card. A case whose inputs come from a
kernel that changed (K4-bf16's and K5-bf16's cases take their y1 or their
output from the bf16 forwards) would compare other inputs, so of the bf16
kernels only K9b-bf16, whose inputs are drawn directly, is here.

    python -m nlspn_eccv20_tpu_torch.tools.compare_outputs --save FILE
    python -m nlspn_eccv20_tpu_torch.tools.compare_outputs --against FILE

Needs the CUDA card.
"""

from __future__ import annotations

import argparse
import json

import torch

from nlspn_eccv20_tpu_torch.ops.kernels.dec_aff_tail import (
    decode_aff_tail, decode_aff_tail_bwd, decode_aff_tail_bwd_case, decode_aff_tail_case,
    decode_aff_tail_fwd_y1)
from nlspn_eccv20_tpu_torch.ops.kernels.dep_encode_front import (
    dep_encode_front, dep_encode_front_bwd, dep_encode_front_bwd_case, dep_encode_front_case)
from nlspn_eccv20_tpu_torch.ops.kernels.small_conv3x3 import (
    small_conv3x3_bwd, small_conv3x3_bwd_case, small_conv3x3_case, small_conv3x3_planar)

# (kernel, batch, height, width, options): K2's and K4's base grid, K3's and
# K5's plane, K9's, K9b's and K9b-bf16's (K outputs beside Ca 192, Cb 64)
CASES = [("K2", 12, 58, 76, {"k": 8}), ("K2", 1, 64, 80, {"k": 8}),
         ("K2", 4, 64, 80, {"k": 8}), ("K2", 1, 64, 80, {"k": 24}),
         ("K2", 1, 57, 75, {"k": 8}), ("K2", 1, 64, 80, {"k": 8, "c": 40}),
         ("K2", 1, 58, 76, {"k": 8, "c": 30}), ("K2", 1, 60, 304, {"k": 8}),
         ("K5", 12, 228, 304, {}), ("K5", 1, 228, 304, {}), ("K5", 2, 230, 306, {}),
         ("K5", 1, 228, 304, {"c": 96}), ("K5", 1, 228, 304, {"c": 30}),
         ("K4", 12, 58, 76, {"k": 8}), ("K4", 1, 58, 76, {"k": 24}),
         ("K3", 12, 228, 304, {}), ("K3", 1, 256, 320, {}), ("K3", 4, 256, 320, {}),
         ("K3", 1, 240, 1216, {}), ("K3", 1, 228, 304, {"c": 96}),
         ("K3", 1, 230, 306, {}), ("K3", 1, 228, 304, {"c": 30}),
         ("K9", 1, 256, 320, {"k": 10}), ("K9", 2, 57, 75, {"k": 26}),
         ("K9b", 1, 228, 304, {"k": 10}), ("K9b", 2, 57, 75, {"k": 26}),
         ("K9b-bf16", 12, 228, 304, {"k": 10}), ("K9b-bf16", 1, 228, 304, {"k": 10}),
         ("K9b-bf16", 2, 57, 75, {"k": 26}), ("K9b-bf16", 2, 57, 76, {"k": 26})]


def run_case(gen, dev, kname, b, h, w, opts):
    """The case's outputs, as a list of tensors on the host."""
    if kname == "K2":
        args, _ = decode_aff_tail_case(gen, dev, b, h, w, opts["k"], opts.get("c", 256))
        outs = [decode_aff_tail(*args), *decode_aff_tail_fwd_y1(*args)]
    elif kname == "K5":
        args, _ = dep_encode_front_bwd_case(gen, dev, b, h, w, opts.get("c", 256))
        outs = list(dep_encode_front_bwd(*args))
    elif kname == "K3":
        args, _ = dep_encode_front_case(gen, dev, b, h, w, opts.get("c", 256))
        outs = [dep_encode_front(*args)]
    elif kname == "K9":
        args, _ = small_conv3x3_case(gen, dev, b, h, w, opts["k"])
        outs = [small_conv3x3_planar(*args)]
    elif kname in ("K9b", "K9b-bf16"):
        dtype = torch.bfloat16 if kname == "K9b-bf16" else torch.float32
        args, _ = small_conv3x3_bwd_case(gen, dev, b, h, w, opts["k"], dtype=dtype)
        outs = list(small_conv3x3_bwd(*args))
    else:
        args, _ = decode_aff_tail_bwd_case(gen, dev, b, h, w, opts["k"])
        outs = list(decode_aff_tail_bwd(*args))
    torch.cuda.synchronize()
    return [t.detach().cpu() for t in outs]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    mode = ap.add_mutually_exclusive_group(required=True)
    mode.add_argument("--save", metavar="FILE")
    mode.add_argument("--against", metavar="FILE")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("compare_outputs needs the CUDA card")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    gen = torch.Generator().manual_seed(0)
    results = [run_case(gen, dev, *case) for case in CASES]
    if args.save:
        torch.save(results, args.save)
        return 0
    saved = torch.load(args.against)
    same_all = True
    for case, got, want in zip(CASES, results, saved):
        diffs = [(g.float() - s.float()).abs().max().item() for g, s in zip(got, want)]
        same = all(torch.equal(g, s) for g, s in zip(got, want))
        same_all &= same
        print(json.dumps({"name": case[0], "batch": case[1], "shape": list(case[2:4]),
                          **case[4], "equal_bits": same, "max_abs_diff": max(diffs)}),
              flush=True)
    print(json.dumps({"all_equal_bits": same_all}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
