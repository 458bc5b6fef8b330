"""Rank processes for the port's data-parallel tests, on the CPU with gloo.

``Ranks(job, workdir)`` starts two copies of this file at once with
torchrun's variables set (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
``MASTER_ADDR``, ``MASTER_PORT``); its ``wait()`` (or ``spawn``, which
waits) kills every copy once the time limit passes.
Each copy joins the process group through the port's
``maybe_initialize_distributed`` (``platform='cpu'``: gloo), runs ``job``
on its shard of the inputs the test saved to ``<workdir>/inputs.pt``, and
saves what it saw to ``<workdir>/rank<r>.pt``. The copies import torch and
the port only; the tests hold their results against the JAX package.

Jobs:
  ``parallel``  the synchronised BatchNorm (f32 and bf16) on half a batch
                each, the test loop over an odd split, ``Engine.train_step``
                on half a global batch (of two configurations), and the
                refusals of ``main``;
  ``main``      ``python -m nlspn_eccv20_tpu_torch.main`` with the given
                arguments, recording any file a rank other than 0 writes.
"""

import os
import socket
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


class Ranks:
    """``ranks`` processes running ``job``, started at once; ``wait()``
    returns their outputs, and raises if one failed or the time limit
    passed (every process is killed then)."""

    def __init__(self, job, workdir, args=(), ranks=2, timeout=240):
        port = free_port()
        self.job, self.timeout = job, timeout
        self.deadline = time.monotonic() + timeout
        self.procs = []
        for r in range(ranks):
            env = dict(os.environ, RANK=str(r), WORLD_SIZE=str(ranks), LOCAL_RANK=str(r),
                       MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                       OMP_NUM_THREADS="1", PYTHONPATH=REPO)
            self.procs.append(subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), job, str(workdir), *args],
                env=env, cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True, start_new_session=True))

    def wait(self):
        outs = []
        try:
            for p in self.procs:
                outs.append(p.communicate(
                    timeout=max(self.deadline - time.monotonic(), 1))[0])
        except subprocess.TimeoutExpired:
            for p in self.procs:
                p.kill()
            for p in self.procs:
                p.communicate()
            raise AssertionError(f"{self.job}: the ranks did not finish in "
                                 f"{self.timeout} s")
        for r, (p, out) in enumerate(zip(self.procs, outs)):
            assert p.returncode == 0, f"rank {r} of {self.job} exited {p.returncode}:\n{out}"
        return outs


def spawn(job, workdir, args=(), ranks=2, timeout=240):
    """``Ranks(...).wait()``: run ``job`` to its end in ``ranks`` processes."""
    return Ranks(job, workdir, args, ranks, timeout).wait()


# ---- the jobs, run in the rank processes ----

def _half(t, r):
    n = t.shape[0] // 2
    return t[r * n:(r + 1) * n]


def _batchnorm(inp, r):
    import torch
    import torch.distributed as dist

    from nlspn_eccv20_tpu_torch.models.common import BatchNorm

    out = {}
    for dtype in (torch.float32, torch.bfloat16):
        bn = BatchNorm(inp["bn_x"].shape[1]).train()
        with torch.no_grad():
            bn.weight.copy_(inp["bn_scale"])
            bn.bias.copy_(inp["bn_bias"])
        x = _half(inp["bn_x"], r).to(dtype).requires_grad_()
        y = bn(x)
        y.backward(_half(inp["bn_g"], r).to(dtype))
        for p in (bn.weight, bn.bias):   # each rank's share, as the step adds them
            dist.all_reduce(p.grad)
        key = str(dtype).split(".")[-1]
        out[key] = {"y": y.detach(), "dx": x.grad, "dscale": bn.weight.grad,
                    "dbias": bn.bias.grad, "mean": bn.running_mean.clone(),
                    "var": bn.running_var.clone(), "y_dtype": str(y.dtype),
                    "dx_dtype": str(x.grad.dtype)}
    return out


def _test_loop(inp, r, workdir):
    """``main.test`` over the test split cut to ``inp['test_len']`` samples;
    the metric rows rank 0's summary received."""
    import numpy as np

    from nlspn_eccv20_tpu_torch import main as pmain
    from nlspn_eccv20_tpu_torch.config import Config
    from nlspn_eccv20_tpu_torch.data.synthetic import Synthetic
    from nlspn_eccv20_tpu_torch.summary import Summary
    from nlspn_eccv20_tpu_torch.train import Engine

    Synthetic.SPLIT_SIZES = dict(Synthetic.SPLIT_SIZES, test=inp["test_len"])
    rows = []
    add = Summary.add

    def counting_add(self, loss=None, metric=None):
        rows.append(np.asarray(metric))
        add(self, loss, metric)

    Summary.add = counting_add
    try:
        cfg = Config(**inp["cfg"], save_dir=os.path.join(workdir, "test")).finalize()
        eng = Engine(cfg, device="cpu")
        eng.init_state(inp["state_dict"])
        summary = pmain.test(cfg, eng)
    finally:
        Summary.add = add
    return {"summary": summary, "rows": np.concatenate(rows) if rows else None}


def _train_step(inp, r, cfg_kw=None, state_dict=None):
    import torch

    from nlspn_eccv20_tpu_torch.config import Config
    from nlspn_eccv20_tpu_torch.train import Engine

    cfg = Config(**(cfg_kw or inp["cfg"]))
    eng = Engine(cfg, steps_per_epoch=1, device="cpu")
    sd = inp["state_dict"] if state_dict is None else state_dict
    if r:   # another start on rank 1: init_state must replace it by rank 0's
        sd = {k: v + 1 if v.is_floating_point() else v for k, v in sd.items()}
    model = eng.init_state(sd)
    start = {k: v.clone() for k, v in model.state_dict().items()}
    batch = {k: _half(v, r) for k, v in inp["batch"].items()}
    aux = eng.train_step(eng.put_train_batch(batch))
    return {"start": start, "loss": aux["loss"], "loss_val": aux["loss_val"],
            "metric": aux["metric"],
            "grads": {n: p.grad.clone() for n, p in model.named_parameters()
                      if p.grad is not None},
            "after": {k: v.clone() for k, v in model.state_dict().items()},
            "batch_rows": int(batch["rgb"].shape[0])}


def _refusals(inp, workdir):
    """``main`` with a configuration the two ranks cannot run: the
    ``ValueError`` each raised before any data was read."""
    from nlspn_eccv20_tpu_torch import main as pmain
    from nlspn_eccv20_tpu_torch.config import Config

    def never(*_, **__):
        raise AssertionError("reached past the checks")

    saved = {n: getattr(pmain, n) for n in ("get_dataset", "train", "test", "Engine")}
    out = {}
    try:
        for n in saved:
            setattr(pmain, n, never)
        for name, kw in inp["refuse"].items():
            cfg = Config(**{**inp["cfg"], **kw},
                         save_dir=os.path.join(workdir, name)).finalize()
            try:
                pmain.main(cfg)
                out[name] = None
            except ValueError as e:
                out[name] = str(e)
    finally:
        for n, f in saved.items():
            setattr(pmain, n, f)
    return out


def _run_parallel(workdir):
    import torch
    import torch.distributed as dist

    from nlspn_eccv20_tpu_torch.config import Config
    from nlspn_eccv20_tpu_torch.parallel.mesh import (
        maybe_initialize_distributed,
        world_size,
    )

    torch.set_num_threads(1)
    sys.modules["torch.utils.tensorboard"] = None   # its import outlasts the job
    inp = torch.load(os.path.join(workdir, "inputs.pt"), weights_only=False)
    assert maybe_initialize_distributed(Config(platform="cpu"))
    r = dist.get_rank()
    res = {"world": world_size(), "backend": dist.get_backend(),
           "batchnorm": _batchnorm(inp, r),
           "test_loop": _test_loop(inp, r, workdir),
           "train_step": _train_step(inp, r),
           "train_step_other": _train_step(inp, r, inp["other_cfg"], inp["other_state_dict"]),
           "refusals": _refusals(inp, workdir)}
    torch.save(res, os.path.join(workdir, f"rank{r}.pt"))
    dist.destroy_process_group()


def _run_main(workdir, argv):
    """The CLI as ``python -m`` runs it. On ranks other than 0 every file
    opened for writing, directory made or checkpoint saved under the run's
    experiments directory is recorded in ``<workdir>/writes<r>.txt``.
    TensorBoard is left out: its import alone outlasts the run."""
    import runpy

    sys.modules["torch.utils.tensorboard"] = None
    r = int(os.environ["RANK"])
    if r:
        import torch

        exp = os.path.abspath(argv[argv.index("--experiments_dir") + 1])
        log = open(os.path.join(workdir, f"writes{r}.txt"), "w")

        def note(path):
            if str(path).startswith(exp):
                log.write(f"{path}\n")
                log.flush()

        def hook(event, args):
            if event == "open" and args[1] and any(c in str(args[1]) for c in "wax+"):
                note(os.path.abspath(str(args[0])))
            elif event in ("os.mkdir", "os.rename", "os.replace", "os.remove"):
                note(os.path.abspath(str(args[0])))

        sys.addaudithook(hook)
        save = torch.save

        def recorded_save(obj, f, *a, **kw):
            note(os.path.abspath(str(f)))
            return save(obj, f, *a, **kw)

        torch.save = recorded_save
    sys.argv = ["nlspn_eccv20_tpu_torch.main", *argv]
    runpy.run_module("nlspn_eccv20_tpu_torch.main", run_name="__main__", alter_sys=True)


if __name__ == "__main__":
    job, workdir = sys.argv[1], sys.argv[2]
    if job == "parallel":
        _run_parallel(workdir)
    elif job == "main":
        _run_main(workdir, sys.argv[3:])
    else:
        raise SystemExit(f"unknown job {job}")
