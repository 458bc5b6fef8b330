"""The port's command line held against the JAX package's: the same flags
parse to the same Config fields, and ``--resume`` reloads the saved config
the same way."""

import dataclasses
import os

import pytest

from nlspn_eccv20_tpu import config as jconfig
from nlspn_eccv20_tpu_torch import config as pconfig


def option_strings(parser):
    return sorted(s for a in parser._actions for s in a.option_strings)


def test_same_flags():
    assert option_strings(pconfig.build_parser()) == option_strings(jconfig.build_parser())


def _argv_for(action, flag):
    """An argv fragment that gives ``action`` (through ``flag``) a value
    other than its default, where it has another."""
    if action.nargs == 0:                          # store_true / store_false
        return [flag]
    if action.choices:
        return [flag, next((c for c in action.choices if c != action.default),
                           action.default)]
    if action.nargs == 2:
        return [flag, "0.8", "0.95"]
    if action.type is int:
        return [flag, str((action.default or 0) + 2)]
    if action.type is float:
        return [flag, str((action.default or 0.0) + 0.25)]
    return [flag, "x_" + flag.strip("-")]


def every_flag():
    """One argv for each option string of the parser: every flag, each
    --no_* flag and its positive twin apart."""
    return [_argv_for(action, flag)
            for action in pconfig.build_parser()._actions
            if action.option_strings and action.dest not in ("help", "save_dir", "resume")
            for flag in action.option_strings]


ARGVS = every_flag() + [
    [],
    ["--data_name", "KITTIDC", "--split_json", "data_json/kitti_dc_test.json",
     "--patch_height", "240", "--patch_width", "1216", "--top_crop", "100",
     "--test_crop", "--max_depth", "90"],
    ["--no_augment", "--no_warm_up", "--no_save_full", "--no_use_GRU",
     "--no_use_S2D", "--no_zero_init_aff", "--no_preserve_input",
     "--no_conf_prop", "--no_compile_cache"],
    ["--augment", "--warm_up", "--save_full", "--use_GRU", "--use_S2D",
     "--zero_init_aff", "--preserve_input", "--conf_prop", "--compile_cache"],
    ["--offset", "--offset_window", "0", "--prop_kernel", "5", "--prop_time", "18",
     "--affinity", "AS", "--prop_impl", "pallas", "--always_clip"],
    ["--optimizer", "SGD", "--momentum", "0.8", "--decay", "3,6", "--gamma",
     "1.0,0.5", "--lr", "0.01", "--weight_decay", "1e-4", "--betas", "0.5", "0.9"],
    ["--platform", "cpu", "--seed", "3", "--loss", "1.0*L1"],
    ["--test_only", "--pretrain", "/x/model.pt", "--save_image", "--save_result_only"],
]


@pytest.mark.parametrize("argv", ARGVS, ids=lambda a: " ".join(a) or "defaults")
def test_parse_args_equals_jax(argv, tmp_path):
    argv = argv + ["--save_dir", str(tmp_path / "run")]
    got = dataclasses.asdict(pconfig.parse_args(argv))
    assert got == dataclasses.asdict(jconfig.parse_args(argv))
    if argv[0].startswith("--no_") and len(argv) == 3:
        assert got[argv[0][len("--no_"):]] is False


def test_every_field_is_a_flag():
    dests = {a.dest for a in pconfig.build_parser()._actions}
    assert {f.name for f in dataclasses.fields(pconfig.Config)} <= dests
    assert len(ARGVS) > len(dests)


def test_save_dir_is_derived_when_not_given():
    cfg = pconfig.parse_args(["--save", "trial7", "--experiments_dir", "exps"])
    assert cfg.save_dir.startswith("exps/") and cfg.save_dir.endswith("_trial7")
    assert cfg.profile_dir == cfg.save_dir + "/profile"


@pytest.mark.parametrize("writer", [pconfig, jconfig])
def test_resume_reloads_args_json_as_jax_does(writer, tmp_path):
    run = tmp_path / "run"
    run.mkdir()
    saved = writer.Config(epochs=7, batch_size=4, lr=0.01, prop_time=6,
                          dir_data="/old/data", save_dir=str(run)).finalize()
    (run / "args.json").write_text(saved.to_json())
    argv = ["--resume", "--pretrain", str(run), "--dir_data", "/new/data",
            "--test_only", "--epochs", "99", "--lr", "5"]
    got = pconfig.parse_args(argv)
    assert dataclasses.asdict(got) == dataclasses.asdict(jconfig.parse_args(argv))
    assert (got.epochs, got.lr, got.prop_time, got.batch_size) == (7, 0.01, 6, 4)
    assert (got.dir_data, got.test_only, got.resume) == ("/new/data", True, True)
    assert got.save_dir == got.pretrain == str(run)


def test_resume_needs_a_saved_run(tmp_path):
    with pytest.raises(ValueError, match="--pretrain"):
        pconfig.parse_args(["--resume", "--save_dir", str(tmp_path)])
    with pytest.raises(FileNotFoundError, match="args.json"):
        pconfig.parse_args(["--resume", "--pretrain", str(tmp_path)])


def test_main_module_parses_the_command_line(monkeypatch, tmp_path):
    """``python -m nlspn_eccv20_tpu_torch.main`` hands sys.argv to
    parse_args and that to main; an unknown platform is refused before any
    work."""
    import runpy
    import sys

    monkeypatch.setattr(sys, "argv", ["main", "--platform", "tpu", "--save_dir",
                                      str(tmp_path / "r")])
    with pytest.raises(ValueError, match="unknown platform 'tpu'"):
        runpy.run_module("nlspn_eccv20_tpu_torch.main", run_name="__main__")
    assert not os.path.exists(tmp_path / "r")
