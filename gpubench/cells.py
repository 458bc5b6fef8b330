"""One run of a cell: set-up, warm-up, the measured window, the traced
sub-window, and the comparison with the reference.

A training cell builds one ``train.Engine``, loads the seed's weights,
drives it through ``check_steps`` steps of ``put_train_batch`` +
``train_step`` on distinct pool batches (they are the warm-up too; the
program's readings of them are kept), a few more warm-up steps, and then
steps back to back for the window. A serving cell builds one
``serve.Predictor`` and one client sends the pool's requests through
``predict_batch``: each as the last one returns (the card saturated), or,
where the traffic gives ``rate_hz``, each at its due time i / rate (an
open loop: a request that waits behind a late one counts the wait); it
keeps a sample of the answers drawn from the seed. Once the window has closed and the
memory peak has been read, the program is freed and the reference runs
on the same weights and inputs.
"""

from __future__ import annotations

import gc
import os
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np
import torch

from gpubench import check, generator
from gpubench.reference import model as ref_model
from gpubench.reference.train import readings
from gpubench.reference.weights import make_weights
from gpubench.roofline import PEAKS, bound_s, ops_of_step, part
from gpubench.roofline.flops import model_flops
from gpubench.trace import SPAN_PREFIX, DeviceTrace, Spans, port_kernel_names


class Card:
    """The device a run uses: the CUDA card, or the CPU in the harness's
    own tests."""

    def __init__(self, device):
        self.device = torch.device(device)
        self.cuda = self.device.type == "cuda"

    def sync(self) -> None:
        if self.cuda:
            torch.cuda.synchronize(self.device)

    def reset_peak(self) -> None:
        if self.cuda:
            torch.cuda.reset_peak_memory_stats(self.device)

    def peak(self) -> int:
        return torch.cuda.max_memory_allocated(self.device) if self.cuda else 0

    def free(self) -> None:
        gc.collect()
        if self.cuda:
            torch.cuda.empty_cache()

    @property
    def name(self) -> str:
        return torch.cuda.get_device_name(self.device) if self.cuda else "cpu"

    @property
    def program_device(self):
        """What the port's entry points take: None (the current card) or
        the CPU."""
        return None if self.cuda else "cpu"


@dataclass
class Window:
    """What the measured window saw."""
    kind: str
    seconds: float = 0.0
    units: int = 0            # optimizer steps or requests
    images: int = 0           # training images in those steps
    frames: int = 0           # frames returned
    latencies_s: List[float] = field(default_factory=list)
    failed: int = 0
    setup_s: float = 0.0
    peak_bytes: int = 0       # max_memory_allocated over the window
    process_peak_bytes: int = 0


@dataclass
class Reading:
    """What a per-layer metric's reader gets."""
    cell: object
    window: Window
    trace: Optional[DeviceTrace]
    spans: Spans
    device_name: str

    def device_ms(self, group: str) -> Optional[float]:
        return None if self.trace is None else self.trace.group_ms(group)

    def launches(self) -> Optional[float]:
        return None if self.trace is None else self.trace.launches()

    def idle_share(self) -> Optional[float]:
        if self.trace is None or self.trace.busy_s <= 0:
            return None
        return 100.0 * (1.0 - self.trace.busy_s / self.trace.window_s)

    def span_ms(self, name: str) -> Optional[float]:
        return self.spans.mean_ms(name)

    def _shape(self):
        t = self.cell.traffic
        if t["kind"] == "train":
            return t["batch"], t["height"], t["width"], True
        bucket = t["bucket"]
        return (t["frames"], -(-t["height"] // bucket) * bucket,
                -(-t["width"] // bucket) * bucket, False)

    def kernel_roofline(self) -> Optional[float]:
        """Sum of calls x bound over the port's kernels' device time, per
        step or request, in %."""
        ms = self.device_ms("port")
        if not ms:
            return None
        peak = PEAKS[part(self.device_name)]
        b, h, w, train = self._shape()
        least = sum(n * bound_s(f, nb, peak)
                    for _, n, f, nb in ops_of_step(self.cell.config["config"], b, h, w, train))
        return 100.0 * least / (ms * 1e-3)

    def mfu(self) -> Optional[float]:
        """Model FLOPs a second as % of the float32 peak: over the window's
        steps or requests where they came back to back; where the traffic
        sets the rate, a request's FLOPs over its median latency."""
        if self.window.seconds <= 0 or not self.window.units:
            return None
        b, h, w, train = self._shape()
        flops = model_flops(ref_model.load_config(self.cell.config["config"]), b, h, w, train)
        if "rate_hz" in self.cell.traffic:
            per_s = 1.0 / float(np.median(self.window.latencies_s))
        else:
            per_s = self.window.units / self.window.seconds
        return 100.0 * flops * per_s / (PEAKS[part(self.device_name)]["f32_tflops"] * 1e12)


class Phases:
    """Seconds since the process started at each step of the set-up."""

    def __init__(self, t_start: float):
        self.t_start = t_start
        self.marks = [("imports", time.perf_counter() - t_start)]

    def mark(self, name: str) -> None:
        self.marks.append((name, time.perf_counter() - self.t_start))

    def line(self) -> str:
        return "set-up: " + ", ".join(f"{n} by {s:.2f} s" for n, s in self.marks)


def program_config(cell):
    """The port's ``Config`` for a cell: the configuration file's fields,
    the traffic's batch, patch and optimizer settings."""
    from nlspn_eccv20_tpu_torch.config import Config

    t = cell.traffic
    extra = {}
    if t["kind"] == "train":
        extra = dict(batch_size=t["batch"], patch_height=t["height"],
                     patch_width=t["width"], lr=t["lr"], warm_up=t["warm_up"],
                     optimizer="ADAM", betas=tuple(t["betas"]), epsilon=t["eps"],
                     weight_decay=0.0)
    return Config(**cell.config["config"], **extra)


def _profile(card: Card, units: int, one, port: frozenset) -> DeviceTrace:
    """The device's activity over ``units`` calls of ``one``, back to back.
    One call runs first under the profiler and is left out, with a
    synchronise after it, so that the profiler's start is not read as the
    cell's."""
    from torch.profiler import ProfilerActivity, profile, record_function

    card.sync()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        one(-1)
        card.sync()
        with record_function(SPAN_PREFIX + "window"):
            for i in range(units):
                one(i)
            card.sync()
    return DeviceTrace.from_profiler(prof, units, port)


def _csrc() -> str:
    import nlspn_eccv20_tpu_torch

    return os.path.join(os.path.dirname(nlspn_eccv20_tpu_torch.__file__), "csrc")


def train_program(cell, seed: int, seconds: float, trace: bool, card: Card, t_start: float):
    """The program's side of a training run: (window, trace or None, its
    readings of the compared steps, set-up phases)."""
    from nlspn_eccv20_tpu_torch.train import Engine

    t = cell.traffic
    c = ref_model.load_config(cell.config["config"])
    phases = Phases(t_start)
    pool = generator.train_pool(t, seed)
    phases.mark("inputs")
    eng = Engine(program_config(cell), steps_per_epoch=t["steps_per_epoch"],
                 device=card.program_device)
    phases.mark("engine")
    eng.init_state(make_weights(c, seed, card.device))
    phases.mark("weights")
    start = {n: p.detach().clone() for n, p in eng.model.named_parameters()}
    beta1 = t["betas"][0]
    losses, grads = [], {}
    for s in range(t["check_steps"]):
        aux = eng.train_step(eng.put_train_batch(pool[s]))
        losses.append(aux["loss"])
        if s == 0:
            state = eng.optimizer.state
            grads = {n: state[p]["exp_avg"].norm() / (1 - beta1)
                     for n, p in eng.model.named_parameters() if p in state}
    change = {n: (p.detach() - start[n]).norm() for n, p in eng.model.named_parameters()}
    program = {"loss": [float(x) for x in losses],
               "grad": {n: float(x) for n, x in grads.items()},
               "change": {n: float(x) for n, x in change.items()}}
    del start, grads, change, aux
    phases.mark("checked steps")
    order = generator.order(t, seed)
    for _ in range(t["warmup_steps"]):
        eng.train_step(eng.put_train_batch(pool[next(order)]))
    card.sync()
    phases.mark("warm-up steps")
    win = Window("train", setup_s=time.perf_counter() - t_start,
                 process_peak_bytes=card.peak())
    card.reset_peak()
    window_losses = []
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        aux = eng.train_step(eng.put_train_batch(pool[next(order)]))
        window_losses.append(aux["loss"])
    card.sync()
    win.seconds = time.perf_counter() - t0
    win.units = len(window_losses)
    win.images = win.units * t["batch"]
    win.failed = int((~torch.isfinite(torch.stack(window_losses))).sum())
    win.peak_bytes = card.peak()
    win.process_peak_bytes = max(win.process_peak_bytes, win.peak_bytes)
    dev_trace = None
    if trace:
        dev_trace = _profile(
            card, t["trace_units"],
            lambda i: eng.train_step(eng.put_train_batch(pool[next(order)])),
            port_kernel_names(_csrc()))
    del eng, aux, window_losses
    card.free()
    return win, dev_trace, program, phases


def train_reference(cell, seed: int, card: Card) -> Dict:
    """The reference's readings of the same steps from the same weights."""
    t = cell.traffic
    c = ref_model.load_config(cell.config["config"])
    return readings(c, make_weights(c, seed, card.device),
                    generator.train_pool(t, seed)[:t["check_steps"]],
                    {"lr": t["lr"], "betas": t["betas"], "eps": t["eps"]})


def run_train(cell, seed: int, seconds: float, trace: bool, card: Card, t_start: float):
    win, dev_trace, program, phases = train_program(cell, seed, seconds, trace, card, t_start)
    numbers, notes = check.train_numbers(program, train_reference(cell, seed, card),
                                         cell.traffic["depth_range"])
    return win, dev_trace, Spans(), numbers, [phases.line()] + notes


def reference_answers(c, weights, requests, bucket: int, device, tf32: bool = False):
    """The reference's depth maps for serving requests, each frame's cropped
    to its own size: one list of maps a request."""
    out = []
    with torch.no_grad():
        for rgbs, deps in requests:
            rgb, dep = ref_model.prepare(rgbs, deps, bucket, device)
            pred = ref_model.forward(weights, c, rgb, dep, train=False, tf32=tf32)
            pred = pred[:, 0].cpu().numpy()
            out.append([pred[i, :d.shape[0], :d.shape[1]] for i, d in enumerate(deps)])
    return out


def run_serve(cell, seed: int, seconds: float, trace: bool, card: Card, t_start: float):
    from nlspn_eccv20_tpu_torch.serve import Predictor

    t = cell.traffic
    c = ref_model.load_config(cell.config["config"])
    phases = Phases(t_start)
    pool = generator.serve_pool(t, seed)
    phases.mark("inputs")
    predictor = Predictor(program_config(cell), state_dict=make_weights(c, seed, card.device),
                          device=card.program_device, bucket=t["bucket"])
    phases.mark("predictor")
    order = generator.order(t, seed)
    for _ in range(t["warmup_requests"]):
        predictor.predict_batch(*pool[next(order)])
    card.sync()
    phases.mark("warm-up requests")
    spans = Spans()
    if trace:
        spans.wrap(predictor, "make_sample", "make_sample")
    win = Window("serve", setup_s=time.perf_counter() - t_start,
                 process_peak_bytes=card.peak())
    card.reset_peak()
    # a uniform sample of the window's answers, drawn from the seed
    keep = t["compare_answers"]
    rng = np.random.default_rng([int(seed), 4])
    kept: List = []
    rate = t.get("rate_hz")
    t0 = time.perf_counter()
    while True:
        # open loop: request i is due at i / rate; else each as the last returns
        due = t0 + win.units / rate if rate else time.perf_counter()
        if due - t0 >= seconds:
            break
        while time.perf_counter() < due:    # a spin: a sleeping client wakes late
            pass
        item = next(order)
        rgbs, deps = pool[item]
        out = predictor.predict_batch(rgbs, deps)
        win.latencies_s.append(time.perf_counter() - due)
        win.frames += len(out)
        if len(out) != len(rgbs) or any(o.shape != d.shape for o, d in zip(out, deps)):
            win.failed += 1
        slot = len(kept) if len(kept) < keep else int(rng.integers(0, win.units + 1))
        if slot < keep:
            kept[slot:slot + 1] = [(item, out)]
        win.units += 1
    win.seconds = time.perf_counter() - t0
    win.peak_bytes = card.peak()
    win.process_peak_bytes = max(win.process_peak_bytes, win.peak_bytes)
    dev_trace = None
    if trace:
        # the sub-window's calls are named for the profiler, and stay out
        # of the window's spans; they come back to back, so that its idle
        # share is the share of a request the device waits on the host
        del predictor.make_sample
        labels = Spans()
        labels.wrap(predictor, "make_sample", "make_sample")
        labels.wrap(predictor, "predict_batch", "predict_batch")
        dev_trace = _profile(card, t["trace_units"],
                             lambda i: predictor.predict_batch(*pool[next(order)]),
                             port_kernel_names(_csrc()))
    del predictor
    card.free()
    items = sorted({i for i, _ in kept})
    ref_out = dict(zip(items, reference_answers(
        c, make_weights(c, seed, card.device), [pool[i] for i in items], t["bucket"],
        card.device)))
    prog = [o for _, out in kept for o in out]
    ref = [o for item, _ in kept for o in ref_out[item]]
    numbers = {"depth_gap": check.depth_gap(prog, ref, t["depth_range"]),
               "depth_excess": check.depth_excess(prog + ref, t["depth_range"])}
    largest = max(float(np.abs(r).max()) for r in ref)
    notes = [phases.line(), f"{len(kept)} answers compared ({len(prog)} frames, "
             f"{len(ref_out)} distinct requests), largest reference depth {largest:.4g}"]
    return win, dev_trace, spans, numbers, notes
