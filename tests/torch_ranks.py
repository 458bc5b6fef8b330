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
                arguments, recording any file a rank other than 0 writes;
  ``width``     width sharding (``num_spatial_shards`` = the ranks, or half
                of 4): the halo exchange and the whole-width gather on a
                tensor's strips, with a conv and a transposed conv through
                them forward and backward; the synchronised BatchNorm on
                ragged strips; ``Engine.eval_step`` and ``train_step`` of
                each case in ``inputs.pt`` on the rank's strip of its data
                shard's images; the ragged case's step in float64; and the
                refusal of a strip without a column;
  ``one``       (one process, no group) the one-process steps the ``width``
                tests hold the ranks to;
  ``width_offset``  ``offset=True`` on width strips (as ``width``): each
                case's eval step and train step on the rank's strips, with
                the route its offset steps took (a halo of their reach, or
                the whole width); on 2 ranks also the float64 steps;
  ``offset_one``  (one process) the one-process steps the
                ``width_offset`` tests hold the ranks to.
"""

import os
import socket
import subprocess
import sys
import threading
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


_GIVEN = set()   # ports handed out here: groups started at once must not share one


def free_port() -> int:
    """A port free now and not handed out before in this process (a group's
    rank 0 binds it only once its process has started)."""
    while True:
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            port = s.getsockname()[1]
        if port not in _GIVEN:
            _GIVEN.add(port)
            return port


class Ranks:
    """``ranks`` processes running ``job``, started at once; ``wait()``
    returns their outputs, and raises if one failed (at once: the others,
    waiting for it in a collective, are killed) or the time limit passed
    (every process is killed then)."""

    def __init__(self, job, workdir, args=(), ranks=2, timeout=240):
        port = free_port()
        self.job, self.timeout = job, timeout
        self.deadline = time.monotonic() + timeout
        self.procs, self.outs, self.readers = [], [], []
        for r in range(ranks):
            env = dict(os.environ, RANK=str(r), WORLD_SIZE=str(ranks), LOCAL_RANK=str(r),
                       MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                       OMP_NUM_THREADS="1", PYTHONPATH=REPO)
            proc = subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), job, str(workdir), *args],
                env=env, cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True, start_new_session=True)
            out = []   # drained as it comes: a full pipe would stall the rank
            reader = threading.Thread(target=lambda f=proc.stdout, o=out: o.append(f.read()),
                                      daemon=True)
            reader.start()
            self.procs.append(proc)
            self.outs.append(out)
            self.readers.append(reader)

    def _outputs(self):
        for reader in self.readers:
            reader.join(timeout=10)
        return ["".join(o) for o in self.outs]

    def wait(self):
        while True:
            codes = [p.poll() for p in self.procs]
            failed = [r for r, c in enumerate(codes) if c not in (None, 0)]
            late = time.monotonic() > self.deadline
            if failed or late:
                for p in self.procs:
                    p.kill()
                    p.wait()
                outs = self._outputs()
                if failed:
                    r = failed[0]
                    raise AssertionError(f"rank {r} of {self.job} exited {codes[r]}:\n"
                                         f"{outs[r][-4000:]}")
                raise AssertionError(f"{self.job}: the ranks did not finish in "
                                     f"{self.timeout} s; their last output:\n"
                                     + "\n".join(o[-2000:] for o in outs))
            if all(c == 0 for c in codes):
                return self._outputs()
            time.sleep(0.1)


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


def _strip_ops(inp, strips, bounds):
    """The halo and the gather on this rank's strip of ``inp['x']``, and a
    3x3 conv (stride 1 and 2) and the k3/s2 transposed conv through them:
    outputs, and the gradients of rank 0's loss, sum(y * g) over the whole
    outputs (the other ranks' losses are 0); weight gradients summed over
    the ranks."""
    import torch
    import torch.distributed as dist

    from nlspn_eccv20_tpu_torch.models.common import strip_conv2d, strip_conv_transpose2d
    from nlspn_eccv20_tpu_torch.parallel.halo import gather_width, halo

    s = strips.index
    x = inp["x"][..., bounds[s]:bounds[s + 1]].clone().requires_grad_()
    w1, b1, wt = (inp[k].clone().requires_grad_() for k in ("w1", "b1", "wt"))
    ys = {"s1": gather_width(strip_conv2d(x, w1, b1, (1, 1), (1, 1), strips), strips),
          "s2": gather_width(strip_conv2d(x, w1, b1, (2, 2), (1, 1), strips), strips),
          "t": gather_width(strip_conv_transpose2d(x, wt, None, strips), strips)}
    loss = sum((y * inp["g_" + k]).sum() for k, y in ys.items()) * (s == 0)
    loss.backward()
    for p in (w1, b1, wt):
        dist.all_reduce(p.grad)
    return {"halo": halo(x.detach(), strips, 2, 3), "whole": gather_width(x.detach(), strips),
            "y": {k: y.detach() for k, y in ys.items()}, "dx": x.grad,
            "dw1": w1.grad, "db1": b1.grad, "dwt": wt.grad}


def _ragged_batchnorm(inp, r, bounds):
    """The train-mode BatchNorm on strip r of ``inp['bn_x']`` (ragged:
    the strips differ in width)."""
    import torch
    import torch.distributed as dist

    from nlspn_eccv20_tpu_torch.models.common import BatchNorm

    cols = slice(bounds[r], bounds[r + 1])
    bn = BatchNorm(inp["bn_x"].shape[1]).train()
    with torch.no_grad():
        bn.weight.copy_(inp["bn_scale"])
        bn.bias.copy_(inp["bn_bias"])
    x = inp["bn_x"][..., cols].clone().requires_grad_()
    y = bn(x)
    y.backward(inp["bn_g"][..., cols])
    for p in (bn.weight, bn.bias):
        dist.all_reduce(p.grad)
    return {"y": y.detach(), "dx": x.grad, "dscale": bn.weight.grad,
            "dbias": bn.bias.grad, "mean": bn.running_mean.clone(),
            "var": bn.running_var.clone()}


def _width_case(case, r):
    """``case``'s eval step (if asked), then its train step (unless asked
    not to), on this rank's strips of its data shard's images; with
    ``offset=True`` also the route each took (``NLSPNModel.offset_route``)
    and the train step's off_max."""
    from nlspn_eccv20_tpu_torch.config import Config
    from nlspn_eccv20_tpu_torch.train import Engine

    eng = Engine(Config(**case["cfg"]), steps_per_epoch=1, device="cpu")
    model = eng.init_state(case["state_dict"])
    per = case["cfg"]["batch_size"] // eng.mesh.size
    d = r // eng.mesh.space
    shard = {k: v[d * per:(d + 1) * per] for k, v in case["batch"].items()}
    out = {"data": eng.mesh.size, "space": eng.mesh.space, "rows": per, "shard": d}
    if case.get("eval"):
        ev = eng.eval_step(eng.put_eval_batch(shard))
        whole = eng.whole(ev["output"])
        out["eval"] = {"loss_val": ev["loss_val"], "metric": ev["metric"],
                       "route": model.offset_route,
                       **{k: whole[k] for k in ("pred", "pred_init", "confidence", "offset")}}
    if case.get("train", True):
        aux = eng.train_step(eng.put_train_batch(shard))
        out.update(loss=aux["loss"], loss_val=aux["loss_val"], metric=aux["metric"],
                   width=int(aux["output"]["pred"].shape[3]), route=model.offset_route,
                   off_max=aux.get("off_max"),
                   grads={n: p.grad.clone() for n, p in model.named_parameters()
                          if p.grad is not None},
                   after={k: v.clone() for k, v in model.state_dict().items()})
    return out


def _run_width_offset(workdir):
    import torch
    import torch.distributed as dist

    from nlspn_eccv20_tpu_torch.config import Config
    from nlspn_eccv20_tpu_torch.parallel.mesh import maybe_initialize_distributed

    torch.set_num_threads(1)
    inp = torch.load(os.path.join(workdir, "inputs.pt"), weights_only=False)
    assert maybe_initialize_distributed(Config(platform="cpu"))
    r, world = dist.get_rank(), dist.get_world_size()
    space = world if world < 4 else 2
    res = {"world": world, "backend": dist.get_backend(), "cases": {}, "float64": {}}
    for name, case in inp["cases"].items():
        if world in case["worlds"]:
            case = dict(case, cfg=dict(case["cfg"], num_spatial_shards=space))
            res["cases"][name] = _width_case(case, r)
    if world == 2:
        for name, case in inp["float64"].items():
            res["float64"][name] = float64_step(dict(case["cfg"], num_spatial_shards=2),
                                                case["state_dict"], case["batch"])
    torch.save(res, os.path.join(workdir, f"rank{r}.pt"))
    dist.destroy_process_group()


def _run_offset_one(workdir):
    """The one-process references of the ``width_offset`` tests: the f32
    and bf16 steps of the bf16 case and the float64 steps."""
    import torch

    torch.set_num_threads(2)
    inp = torch.load(os.path.join(workdir, "inputs.pt"), weights_only=False)
    bf16 = inp["cases"]["bf16"]
    res = {"bf16": {p: _one_step(dict(bf16["cfg"], precision=p), bf16["state_dict"],
                                 bf16["batch"]) for p in ("f32", "bf16")},
           "float64": {name: float64_step(case["cfg"], case["state_dict"], case["batch"])
                       for name, case in inp["float64"].items()}}
    torch.save(res, os.path.join(workdir, "one.pt"))


def float64_step(cfg_kw, state_dict, batch):
    """One train step of ``Config(**cfg_kw)`` with the model and every cast
    of its in float64 (``Tensor.float`` made ``double`` for the step, and
    restored): its loss and gradients, free of f32's rounding."""
    import torch

    from nlspn_eccv20_tpu_torch.config import Config
    from nlspn_eccv20_tpu_torch.train import Engine

    saved = torch.Tensor.float
    torch.Tensor.float = torch.Tensor.double
    try:
        eng = Engine(Config(**cfg_kw), steps_per_epoch=1, device="cpu")
        eng.model.double()
        eng.model.compute_dtype = torch.float64
        model = eng.init_state(state_dict)
        loss = eng.train_step(eng.put_train_batch(batch))["loss"]
    finally:
        torch.Tensor.float = saved
    return {"loss": loss, "route": model.offset_route,
            "grads": {n: p.grad.clone() for n, p in model.named_parameters()
                      if p.grad is not None}}


def _width_refusals(inp, world):
    """The ``ValueError`` of a strip without a column."""
    import numpy as np

    from nlspn_eccv20_tpu_torch.config import Config
    from nlspn_eccv20_tpu_torch.train import Engine

    out = {}
    base = dict(inp["cases"]["default"]["cfg"], num_spatial_shards=world)
    eng = Engine(Config(**base), device="cpu")
    narrow = {k: np.zeros((1, 16, 8, c), np.float32) for k, c in
              (("rgb", 3), ("dep", 1), ("gt", 1))}
    for name, fn in (("no_column", lambda: eng.put_train_batch(narrow)),):
        try:
            fn()
            out[name] = None
        except ValueError as e:
            out[name] = str(e)
    return out


def _one_step(cfg_kw, state_dict, batch):
    """The port's one-process train step: loss and gradients."""
    from nlspn_eccv20_tpu_torch.config import Config
    from nlspn_eccv20_tpu_torch.train import Engine

    eng = Engine(Config(**cfg_kw), steps_per_epoch=1, device="cpu")
    model = eng.init_state(state_dict)
    loss = eng.train_step(eng.put_train_batch(batch))["loss"].item()
    return loss, {n: p.grad.clone() for n, p in model.named_parameters()
                  if p.grad is not None}


def _run_one(workdir):
    """The one-process references of the ``width`` tests, in a process of
    their own (no process group): the f32 and bf16 steps of the bf16 case,
    the no-GRU case's step, and the ragged case's step in float64."""
    import torch

    torch.set_num_threads(2)
    cases = torch.load(os.path.join(workdir, "inputs.pt"), weights_only=False)["cases"]
    bf16, no_gru, ragged = cases["bf16"], cases["no_gru"], cases["ragged"]
    res = {"bf16": {p: _one_step(dict(bf16["cfg"], precision=p), bf16["state_dict"],
                                 bf16["batch"]) for p in ("f32", "bf16")},
           "no_gru": _one_step(no_gru["cfg"], no_gru["state_dict"], no_gru["batch"]),
           "float64": float64_step(ragged["cfg"], ragged["state_dict"], ragged["batch"])}
    torch.save(res, os.path.join(workdir, "one.pt"))


def _run_width(workdir):
    import torch
    import torch.distributed as dist

    from nlspn_eccv20_tpu_torch.config import Config
    from nlspn_eccv20_tpu_torch.parallel.mesh import (
        make_mesh,
        maybe_initialize_distributed,
        strip_bounds,
    )

    torch.set_num_threads(1)
    inp = torch.load(os.path.join(workdir, "inputs.pt"), weights_only=False)
    assert maybe_initialize_distributed(Config(platform="cpu"))
    r, world = dist.get_rank(), dist.get_world_size()
    space = world if world < 4 else 2
    strips = make_mesh(0, space).strips
    res = {"world": world, "backend": dist.get_backend(), "strips": (strips.index, strips.count),
           "ops": _strip_ops(inp, strips, strip_bounds(inp["x"].shape[3], space)),
           "cases": {}}
    if world == 2:
        res["batchnorm"] = _ragged_batchnorm(inp, r, strip_bounds(inp["bn_x"].shape[3], 2))
        res["refusals"] = _width_refusals(inp, world)
        case = inp["cases"]["ragged"]
        res["float64"] = float64_step(dict(case["cfg"], num_spatial_shards=2),
                                      case["state_dict"], case["batch"])
    for name, case in inp["cases"].items():
        if world in case["worlds"]:
            case = dict(case, cfg=dict(case["cfg"], num_spatial_shards=space))
            res["cases"][name] = _width_case(case, r)
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
    elif job == "width":
        _run_width(workdir)
    elif job == "one":
        _run_one(workdir)
    elif job == "width_offset":
        _run_width_offset(workdir)
    elif job == "offset_one":
        _run_offset_one(workdir)
    else:
        raise SystemExit(f"unknown job {job}")
