"""The yardstick's arithmetic: the model FLOPs at the four cells' shapes,
and each kernel's bound at the shapes the port's kernel table gives it
(chip_smoke's figures for the same shapes)."""

import json
import os

import pytest

from gpubench import roofline
from gpubench.reference.model import load_config
from gpubench.roofline.flops import model_flops

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def config(name):
    with open(os.path.join(ROOT, "gpubench", "configs", name + ".json")) as f:
        return json.load(f)["config"]


@pytest.mark.parametrize("name, b, h, w, train, flops", [
    # fork_nyu_train: batch 12 of 228x304, forward and backward
    ("nlspn_fork", 12, 228, 304, True, 5_107_390_046_208),
    # eccv20_nyu_train
    ("nlspn_eccv20", 12, 228, 304, True, 6_153_933_422_592),
    # eccv20_kitti_serve: one 240x1216 frame in its 256x1216 bucket
    ("nlspn_eccv20", 1, 256, 1216, False, 767_830_261_760),
    # fork_nyu_serve: four 228x304 frames in the 256x320 bucket
    ("nlspn_fork", 4, 256, 320, False, 667_460_567_040),
    # one image of each model, forward, at NYU's 228x304
    ("nlspn_fork", 1, 228, 304, False, 141_914_087_424),
    ("nlspn_eccv20", 1, 228, 304, False, 170_995_826_688),
])
def test_model_flops(name, b, h, w, train, flops):
    assert model_flops(load_config(config(name)), b, h, w, train) == flops


@pytest.mark.parametrize("op, args, us", [
    ("prop_step", (12, 228, 304, 9), 12.91), ("prop_step_bwd", (12, 228, 304, 9), 23.84),
    ("deform_prop", (12, 228, 304, 9), 30.79), ("deform_prop_bwd", (12, 228, 304, 9), 59.59),
    ("dec_aff_tail", (12, 58, 76, 256, 8), 64.86),
    ("dec_aff_tail_bwd", (12, 58, 76, 256, 8), 129.72),
    ("dep_encode_front", (12, 228, 304, 256), 57.51),
    ("dep_encode_front_bwd", (12, 228, 304, 256), 115.91),
    ("prop_step", (1, 256, 320, 9), 1.27), ("dec_aff_tail", (1, 64, 80, 256, 8), 6.28),
    ("dep_encode_front", (1, 256, 320, 256), 5.67), ("deform_prop", (1, 240, 1216, 9), 10.8),
])
def test_kernel_bounds(op, args, us):
    flops, nbytes = getattr(roofline, op)(*args)
    got = roofline.bound_s(flops, nbytes, roofline.PEAKS["SXM"]) * 1e6
    assert abs(got - us) <= 0.005 * us


@pytest.mark.parametrize("name, train, ops", [
    ("nlspn_fork", True, {"prop_step": 12, "prop_step_bwd": 12, "dec_aff_tail": 11,
                          "dep_encode_front": 11, "dec_aff_tail_bwd": 11,
                          "dep_encode_front_bwd": 11}),
    ("nlspn_fork", False, {"prop_step": 12, "dec_aff_tail": 11, "dep_encode_front": 11}),
    ("nlspn_eccv20", True, {"deform_prop": 18, "deform_prop_bwd": 18}),
    ("nlspn_eccv20", False, {"deform_prop": 18}),
])
def test_calls_of_a_step(name, train, ops):
    got = roofline.ops_of_step(config(name), 12, 228, 304, train)
    assert {op: n for op, n, _, _ in got} == ops
