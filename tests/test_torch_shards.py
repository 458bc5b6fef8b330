"""Width shards the devices cannot hold are refused by both packages.

The JAX ``Engine`` builds its mesh with ``make_mesh``, which raises a
``ValueError`` when ``num_spatial_shards`` does not divide the devices it
was given (here the 8 virtual CPU devices of ``conftest.py``). The port runs
on one device and has no width sharding, so its ``Engine`` and ``main``
refuse any count above 1 with the same words, before a model is built or
any data is read; ``num_data_shards`` is accepted, as the JAX mesh accepts
it on one device. No step runs here.
"""

import jax
import pytest

from nlspn_eccv20_tpu.config import Config as JaxConfig
from nlspn_eccv20_tpu.parallel.mesh import make_mesh
from nlspn_eccv20_tpu.train import Engine as JaxEngine
from nlspn_eccv20_tpu_torch import main as port_main
from nlspn_eccv20_tpu_torch.config import Config, parse_args
from nlspn_eccv20_tpu_torch.train import Engine, check_shards


@pytest.mark.parametrize("data_shards", [1, 0])
def test_jax_engine_refuses_too_few_devices(data_shards):
    """16 width shards on 8 devices: an explicit data count fails in
    ``make_mesh``, the automatic one while it looks for a count."""
    assert len(jax.devices()) == 8
    cfg = JaxConfig(num_spatial_shards=16, num_data_shards=data_shards)
    with pytest.raises(ValueError) as err:
        JaxEngine(cfg)
    if data_shards:
        assert str(err.value) == "8 devices not divisible by num_spatial_shards=16"


@pytest.mark.parametrize("shards", [2, 3, 16])
def test_port_engine_refuses_width_shards(shards):
    with pytest.raises(ValueError) as err:
        Engine(Config(num_spatial_shards=shards), device="cpu")
    # the JAX mesh's words on the port's one device
    with pytest.raises(ValueError) as want:
        make_mesh(1, devices=jax.devices()[:1], num_spatial=shards)
    assert str(err.value) == str(want.value) == (
        f"1 devices not divisible by num_spatial_shards={shards}")


def test_port_accepts_data_shards_as_jax_does():
    """``num_data_shards=2`` on one device: the JAX mesh takes it (its
    device list is cut to what there is), and so does the port."""
    assert make_mesh(2, devices=jax.devices()[:1]).devices.size == 1
    check_shards(Config(num_data_shards=2))
    check_shards(Config(num_spatial_shards=1))


def test_port_main_refuses_before_training(tmp_path, monkeypatch):
    """``main --num_spatial_shards 2 --platform cpu`` raises before any
    data is read or any step taken: the dataset and both loops are
    replaced by functions that fail if called."""
    def never(*_, **__):
        raise AssertionError("reached past the shard check")

    for name in ("get_dataset", "train", "test", "Engine"):
        monkeypatch.setattr(port_main, name, never)
    cfg = parse_args(["--num_spatial_shards", "2", "--platform", "cpu",
                      "--data_name", "Synthetic", "--test_pipeline", "--epochs", "1",
                      "--experiments_dir", str(tmp_path)])
    with pytest.raises(ValueError, match="1 devices not divisible by num_spatial_shards=2"):
        port_main.main(cfg)
    assert not any(tmp_path.iterdir())
