"""What the span readers share: the program's spans in the profiled
stretch, and their device and idle time per step.

The program records its spans while a profiler window is open
(``xgan_torch.utils.timer``: ``span``, ``SPANS.collect()``); the stretch
is the only such window of a run. A span's host times lie on the trace's
clock once libkineto's base is subtracted (``timer.trace_us``), so the
spans of the stretch are the roots whose host interval overlaps it (a
step's host work starts before its first kernel), with their
descendants. A span replayed inside a CUDA graph has only device times,
read from the last step of the last replay; an eager step's spans are
read from every step. Where the program records no span (a stretch that
opened none, or a program without ``timer.SPANS``) every function here
returns None.
"""
from __future__ import annotations

from xgan_torch.utils import timer

from . import trace


def host_us(s) -> tuple:
    """A span's host interval on the trace's clock, µs."""
    return timer.trace_us(s.host_start_ns), timer.trace_us(s.host_end_ns)


def in_stretch(stretch: trace.Stretch, spans=None):
    """The spans of ``stretch`` (``spans``, or what the program
    collected), parents before children; None without any."""
    if spans is None:
        if not hasattr(timer, "SPANS"):
            return None
        spans = timer.SPANS.collect()
    keep, out = set(), []
    for s in spans:
        if s.parent is None:
            if s.host_start_ns is None:
                continue
            a, b = host_us(s)
            if b < stretch.start_us or a > stretch.end_us:
                continue
        elif s.parent not in keep:
            continue
        keep.add(s.id)
        out.append(s)
    return out or None


def per_step_ms(stretch: trace.Stretch, names, spans=None):
    """The self device time of the spans named ``names``, in ms per
    ``step`` span of the stretch; None where it has neither."""
    spans = in_stretch(stretch, spans)
    if spans is None:
        return None
    steps = sum(s.name == "step" for s in spans)
    own = timer.self_device_ms(spans)
    picked = [own[s.id] for s in spans if s.name in names and s.id in own]
    if not steps or not picked:
        return None
    return sum(picked) / steps


def idle_by_span(stretch: trace.Stretch, spans=None):
    """The stretch's idle gaps (``trace.idle_gaps``), each put by its
    middle to the innermost span whose host interval holds it (the one
    that started last): ``{span name: idle µs}``, the idle outside every
    span under None; None without spans."""
    spans = in_stretch(stretch, spans)
    if spans is None:
        return None
    # by start, the outer of two that start together first
    timed = sorted(((*host_us(s), s.name) for s in spans
                    if s.host_start_ns is not None),
                   key=lambda t: (t[0], -t[1]))
    out: dict = {}
    for a, b in trace.idle_gaps(stretch):
        mid = (a + b) / 2
        name = None
        for t0, t1, n in timed:
            if t0 > mid:
                break
            if t1 >= mid:
                name = n
        out[name] = out.get(name, 0.0) + (b - a)
    return out


def host_wait_ms(stretch: trace.Stretch, spans=None):
    """The idle inside the program's spans, ms per step of the stretch."""
    idle = idle_by_span(stretch, spans)
    if idle is None:
        return None
    inside = sum(us for name, us in idle.items() if name is not None)
    return inside / 1e3 / stretch.steps
