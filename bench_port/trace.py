"""The profiled stretch of a ``--trace 1`` run and its reduction to events.

The stretch runs a few of the window's calls under ``torch.profiler``
recording the card's activity (kernels, memory copies and sets, and the
CUDA runtime calls that launched them; not every host operator, whose
recording would slow a host-paced step several-fold). It opens with a few
tiny kernels, a sync and half a second of idle host time, and closes with
a sync: the profiler keeps a device event only where its time, mapped from
the card's clock onto the host's, falls inside the profile, and that
mapping can be off by milliseconds, so the margin keeps the stretch's head
in.

The stretch runs from the start of the first device event after that idle
half second to the end of the last one (the sync returns right after it).
``busy`` is the length of the union of its device events, and the idle
gaps are the rest, each named by the innermost CUDA API call (on any
thread) running at its middle, or "host between CUDA calls" where
none was.
"""
from __future__ import annotations

import bisect
import dataclasses
import heapq
import json
import os
import tempfile
import time

import torch

PAD_S = 0.5
LEAD_KERNELS = 64
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cuda_runtime", "cuda_driver")
NO_HOST_EVENT = "host between CUDA calls"
NAME_CHARS = 160


@dataclasses.dataclass
class Stretch:
    """A reduced profile: ``device`` ``[(name, cat, start_us, end_us)]``
    clipped to the stretch, ``start_us``/``end_us`` its edges on the
    trace's clock, ``steps`` the train steps it ran."""
    device: list
    host: list
    start_us: float
    end_us: float
    steps: int

    @property
    def seconds(self) -> float:
        return (self.end_us - self.start_us) / 1e6

    def kernels(self) -> list:
        return [e for e in self.device if e[1] == "kernel"]


def profile_calls(run_calls, n_calls: int, steps_per_call: int) -> Stretch:
    """Run ``run_calls(n_calls)`` (the window's calls, no sync) as the
    profiled stretch; returns its reduction."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        lead = torch.zeros(1, device="cuda")
        for _ in range(LEAD_KERNELS):
            lead.add_(1)
        torch.cuda.synchronize()
        time.sleep(PAD_S)
        run_calls(n_calls)
        torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    return reduce(events, n_calls * steps_per_call)


def reduce(events: list, steps: int) -> Stretch:
    """The stretch's device and host events out of a Chrome trace's: the
    device events after the first idle gap of half the pad or more."""
    dev = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]),
                  e["name"][:NAME_CHARS], e["cat"]) for e in events
                 if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS)
    reach, first = None, None
    for i, (a, b, _, _) in enumerate(dev):
        if reach is not None and a - reach >= PAD_S / 2 * 1e6:
            first = i
            break
        reach = b if reach is None else max(reach, b)
    if first is None:
        raise RuntimeError("no device event after the profile's idle pad")
    device = [(name, cat, a, b) for a, b, name, cat in dev[first:]]
    s0 = device[0][2]
    s1 = max(e[3] for e in device)
    host = []
    for e in events:
        if e.get("ph") == "X" and e.get("cat") in HOST_CATS and "dur" in e:
            a = float(e["ts"])
            b = a + float(e["dur"])
            if b > s0 and a < s1:
                host.append((e["name"][:NAME_CHARS], a, b))
    return Stretch(device, host, s0, s1, steps)


def union(intervals) -> list:
    """Merged ``[(start, end)]`` of ``intervals``, sorted."""
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def busy_us(st: Stretch) -> float:
    return sum(b - a for a, b in union((e[2], e[3]) for e in st.device))


def idle_gaps(st: Stretch) -> list:
    """``[(start, end)]`` of the stretch's time with no device event."""
    gaps, at = [], st.start_us
    for a, b in union((e[2], e[3]) for e in st.device):
        if a > at:
            gaps.append((at, a))
        at = max(at, b)
    if st.end_us > at:
        gaps.append((at, st.end_us))
    return gaps


def host_at(st: Stretch, times: list) -> list:
    """For each time of ``times`` (sorted), the name of the innermost host
    event running then (the one that started last), or
    :data:`NO_HOST_EVENT`."""
    ops = sorted(st.host, key=lambda e: e[1])
    starts = [e[1] for e in ops]
    active = []  # max-heap by start: (-start, end, name)
    out, i = [], 0
    for t in times:
        j = bisect.bisect_right(starts, t)
        while i < j:
            name, a, b = ops[i]
            heapq.heappush(active, (-a, b, name))
            i += 1
        # the latest start that has not ended covers t; an op that ended
        # lower in the heap is dropped once it reaches the top
        while active and active[0][1] < t:
            heapq.heappop(active)
        out.append(active[0][2] if active else NO_HOST_EVENT)
    return out


def breakdown(st: Stretch, top: int = 10) -> dict:
    """The device operations that took the most time, and the idle time
    by what the host was doing, in seconds, ``top`` of each."""
    ops = {}
    for name, _, a, b in st.device:
        ops[name] = ops.get(name, 0.0) + (b - a) / 1e6
    gaps = idle_gaps(st)
    names = host_at(st, [(a + b) / 2 for a, b in gaps])
    idle = {}
    for (a, b), name in zip(gaps, names):
        idle[name] = idle.get(name, 0.0) + (b - a) / 1e6
    return {"device_ops": sorted(ops.items(), key=lambda kv: -kv[1])[:top],
            "idle_gaps": sorted(idle.items(), key=lambda kv: -kv[1])[:top]}
