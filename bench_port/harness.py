"""One run of one cell: set-up, warm-up, the timed window, the optional
profiled stretch, the check against the plain reference, the result line.

Set-up (``setup_s``, from process start to the first timed call) makes the
inputs from ``--seed`` (:mod:`.inputs`), builds the program with the
configuration's ``programs/`` module, and drives its first calls through
the window's own call: those are the steps the check compares (three at
K = 1; at K > 1 the eager call and the first graph replay). A few more calls warm up, so
that every shape, cuDNN plan and graph exists before the window opens.

The window runs whole calls from one ``torch.cuda.synchronize()`` to the
next, nothing in between syncing with the host, until ``--seconds`` have
passed on the host's clock; its length includes the drain of what was
queued. ``train_imgs_per_s`` is batch rows times steps over that length,
``peak_mem_gib`` the allocator's peak over it (reset at its start; the
store and the nets' state count). With ``--trace 1`` the window is
followed by a profiled stretch of the same calls (:mod:`.trace`), and the
per-layer metrics are read from the two.

Then the program's state is freed and the reference (plain float32, TF32
off) follows the compared steps from the same inputs; :mod:`.check`
decides ``correct``. The numbers compared are printed, each beside its
limit, as the last lines of standard error and under ``check``, the last
key of the result line, which is the last line of standard output.
"""
from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import math
import subprocess
import sys
import time

import torch

from . import catalog, check, flops, inputs, trace
from .reference.common import Outputs, on_host, plain_float32

FORBIDDEN = ("jax", "jaxlib", "flax", "xgan")
WARM_CALLS = 3
STRETCH_S = 0.4
MAX_STRETCH_CALLS = 200
GIB = 2.0 ** 30


def compared_calls(k: int) -> int:
    """The first calls whose steps the check compares: three steps at
    K = 1; at K > 1 the eager call and the first graph replay."""
    return 3 if k == 1 else 2


def load(cell_name: str, tiny: bool = False) -> tuple[dict, dict]:
    cell = catalog.cell(cell_name)
    cfg = catalog.config(cell["config"])
    return (shrink(cfg, cell) if tiny else (cfg, cell))


def shrink(cfg: dict, cell: dict) -> tuple[dict, dict]:
    """A CPU-sized copy: 32 px, 8 features, batch 8, 64 store rows, f32."""
    cfg = dict(cfg, image_size=32, feature_maps_g=8, feature_maps_d=8,
               compute_dtype="float32")
    cell = dict(cell, batch=8, store_rows=64)
    return cfg, cell


@dataclasses.dataclass
class Session:
    cfg: dict
    cell: dict
    inp: inputs.Inputs
    prog: object
    compared: Outputs
    next_call: int = 0

    @property
    def k(self) -> int:
        return self.cell["steps_per_call"]

    def call(self) -> torch.Tensor:
        out = self.prog.call(inputs.call_rows(self.inp.order, self.next_call,
                                              self.k))
        self.next_call += 1
        return out

    def calls(self, n: int) -> list:
        return [self.call() for _ in range(n)]

    def close(self) -> None:
        if self.prog is not None:
            self.prog.close()
            self.prog = None
        gc.collect()
        if self.inp.store.is_cuda:
            torch.cuda.empty_cache()


def prepare(cfg: dict, cell: dict, seed: int, device) -> Session:
    """Inputs, the program, and its compared first calls."""
    device = torch.device(device)
    inp = inputs.make(cfg, cell, seed, device)
    w0 = inputs.weights(catalog.reference(cfg).leaves(cfg), seed, device)
    prog = catalog.program(cfg).build(cfg, cell, inp.store, w0,
                                      inp.draw_seed,
                                      getattr(torch, cfg["compute_dtype"]))
    s = Session(cfg, cell, inp, prog, None)
    s.compared = first_calls(s, w0)
    return s


def first_calls(s: Session, w0: dict) -> Outputs:
    """Drive the compared calls. Returns, on the host, the metrics they
    return, each net's first gradient as its optimizer got it (the first
    moment after its first update, over ``1 - beta1``) and the norm of
    each leaf's change after them."""
    first, handles = {}, []
    for net, opt in s.prog.opts.items():
        names = {id(p): n for n, p in s.prog.nets[net].named_parameters()}

        def hook(opt, args, kwargs, net=net, names=names):
            if net in first:
                return
            beta1 = opt.param_groups[0]["betas"][0]
            first[net] = {names[id(p)]: opt.state[p]["exp_avg"].float()
                          / (1.0 - beta1)
                          for group in opt.param_groups
                          for p in group["params"]}
        handles.append(opt.register_step_post_hook(hook))
    try:
        outs = s.calls(compared_calls(s.k))
    finally:
        for h in handles:
            h.remove()
    with torch.no_grad():
        change = {net: {n: float(torch.linalg.vector_norm(
                            p.double() - w0[net][n].double()))
                        for n, p in m.named_parameters()}
                  for net, m in s.prog.nets.items()}
    metrics = [row for o in outs for row in
               o.detach().float().reshape(-1, o.shape[-1]).tolist()]
    return Outputs(metrics, {net: on_host(g) for net, g in first.items()},
                   change)


def reference_outputs(cfg: dict, cell: dict, inp: inputs.Inputs,
                      precision: str = "f32", fault=None) -> Outputs:
    """The plain reference over the compared steps, from the same
    inputs."""
    ref = catalog.reference(cfg)
    w0 = inputs.weights(ref.leaves(cfg), inp.seed, inp.store.device)
    n = compared_calls(cell["steps_per_call"]) * cell["steps_per_call"]
    with plain_float32():
        return ref.run(cfg, cell, inp.store, inp.order, inp.draw_seed, w0, n,
                       precision=precision, fault=fault)


def judge(cfg: dict, cell: dict, inp: inputs.Inputs,
          compared: Outputs) -> tuple[bool, dict]:
    read = check.readings(compared, reference_outputs(cfg, cell, inp), cfg)
    return check.judge(read, cell["limits"])


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def peak_bytes(device: torch.device) -> int:
    return torch.cuda.max_memory_allocated(device) \
        if device.type == "cuda" else 0


def timed_window(s: Session, seconds: float) -> dict:
    """Whole calls from one sync to the next for ``seconds`` of host time;
    nothing inside syncs with the host."""
    dev = s.inp.store.device
    sync(dev)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    outs = []
    t0 = time.perf_counter()
    while True:
        outs.append(s.call())
        if time.perf_counter() - t0 >= seconds:
            break
    sync(dev)
    t1 = time.perf_counter()
    vals = torch.stack([o.detach().float().reshape(-1, o.shape[-1])
                        for o in outs]).reshape(-1, outs[0].shape[-1])
    return {"t0": t0, "seconds": t1 - t0, "calls": len(outs),
            "steps": len(outs) * s.k,
            "failed": int((~torch.isfinite(vals).all(dim=1)).sum()),
            "peak": peak_bytes(dev)}


def card_name_and_limit() -> tuple[str, float | None]:
    name = torch.cuda.get_device_name(0)
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                              "--format=csv,noheader,nounits", "-i", "0"],
                             capture_output=True, text=True, timeout=30,
                             check=True).stdout.strip()
        return name, float(out.splitlines()[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return name, None


def peaks_for(name: str) -> dict | None:
    with open(catalog.HERE / "peaks.json") as f:
        return json.load(f).get(name)


@dataclasses.dataclass
class Context:
    """What a per-layer metric's ``read(ctx)`` gets."""
    cfg: dict
    cell: dict
    peaks: dict | None
    window_s: float
    window_steps: int
    stretch: trace.Stretch
    busy_us: float
    data: dict
    flops: object = flops


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is the JAX stack's or the JAX
    package's (``xgan_torch`` is not ``xgan``)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def parse(argv) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv, t_start: float, device: str = "cuda",
         tiny: bool = False) -> int:
    """One run; returns the exit code. ``device="cpu"`` with ``tiny``
    (tests only) drives the rest of a run on the CPU-sized copy, without
    the look for a card and without tracing."""
    args = parse(argv)
    bench = catalog.benchmark()
    entry = {w["name"]: w for w in bench["workloads"]}.get(args.workload)
    if entry is None:
        print(f"unknown workload {args.workload!r}", file=sys.stderr)
        return 2
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            print("no CUDA device: this benchmark runs only on the card",
                  file=sys.stderr)
            return 2
        if torch.cuda.device_count() < entry["chips"]:
            print(f"{args.workload} needs {entry['chips']} cards, "
                  f"{torch.cuda.device_count()} visible", file=sys.stderr)
            return 2
        card, power = card_name_and_limit()
    elif args.trace:
        print("--trace 1 needs the card", file=sys.stderr)
        return 2
    else:
        card, power = "cpu", None
    cfg, cell = load(args.workload, tiny=tiny)
    s = prepare(cfg, cell, args.seed, dev)
    s.calls(WARM_CALLS)
    sync(dev)
    setup_peak = peak_bytes(dev)
    w = timed_window(s, args.seconds)
    setup_s = w["t0"] - t_start
    stretch = None
    if args.trace:
        n = min(MAX_STRETCH_CALLS,
                max(1, math.ceil(STRETCH_S * w["calls"] / w["seconds"])))
        stretch = trace.profile_calls(s.calls, n, s.k)
    peak = max(setup_peak, w["peak"], peak_bytes(dev))
    inp, compared = s.inp, s.compared
    s.close()
    correct, shown = judge(cfg, cell, inp, compared)

    if args.trace:
        busy = trace.busy_us(stretch)
        ctx_args = dict(cfg=cfg, cell=cell, peaks=peaks_for(card),
                        window_s=w["seconds"], window_steps=w["steps"],
                        stretch=stretch, busy_us=busy)
        metrics = {}
        for m in catalog.metrics_of(bench, args.workload, trace=True):
            ctx = Context(data=catalog.metric_data(m["name"]), **ctx_args)
            value = catalog.metric(m["name"]).read(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        e2e = {"train_imgs_per_s": cell["batch"] * w["steps"] / w["seconds"],
               "peak_mem_gib": w["peak"] / GIB, "setup_s": setup_s}
        metrics = {m["name"]: {"value": e2e[m["name"]], "unit": m["unit"]}
                   for m in catalog.metrics_of(bench, args.workload, False)}

    bad = forbidden_modules()
    if bad:
        print(f"loaded in this process: {', '.join(bad)}", file=sys.stderr)
        return 3
    on_device = {"platform": "gpu" if dev.type == "cuda" else "cpu",
                 "kind": card, "count": 1, "memory_peak_bytes": peak}
    result = {"correct": correct, "attempted": w["steps"],
              "failed": w["failed"], "metrics": metrics, "device": on_device}
    run = f"power_limit_w {power} window_s {w['seconds']} steps {w['steps']}"
    if args.trace:
        on_device["busy_s"] = busy / 1e6
        on_device["window_s"] = stretch.seconds
        result["breakdown"] = trace.breakdown(stretch)
        run += f" stretch_steps {stretch.steps}"
    result["check"] = shown
    print(f"run {card} {run}", file=sys.stderr)
    for name, v in shown.items():
        print(f"check {name} {v['value']} limit {v['limit']}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0
