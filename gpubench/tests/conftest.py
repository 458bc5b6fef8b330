"""Shared helpers of the benchmark's own tests (run with
``python -m pytest gpubench/tests``; they need no card, except those
marked ``card``, which skip without one).

``tiny_cell`` is a cell of ``BENCHMARK.json`` cut to a size the CPU runs
in a second: the configuration's loop and GRU widths, the traffic's
batch, frame and pool sizes. Every other field is the cell's own.
"""

import os

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card; skips without one")
    workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))
    if workers > 1:
        # each worker's share of the cores: workers that each take them all
        # run many times slower than one
        import torch

        torch.set_num_threads(max(1, (os.cpu_count() or 1) // workers))


def shrink(cell):
    cell.config["config"].update(prop_time=3, GRU_hidden_dim=16, GRU_input_dim=16)
    t = cell.traffic
    if t["kind"] == "train":
        t.update(batch=2, height=32, width=48, pool=6, num_sample=50)
    else:
        t.update(height=40, width=64, pool=4, compare_answers=3, warmup_requests=1)
        if "num_sample" in t:
            t["num_sample"] = 50
    return cell


@pytest.fixture
def tiny_cell():
    from gpubench.bench import load

    return lambda workload: shrink(load(ROOT, workload)[0])


@pytest.fixture
def card():
    """The CUDA card; the test skips without one."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from gpubench.cells import Card

    return Card("cuda")
