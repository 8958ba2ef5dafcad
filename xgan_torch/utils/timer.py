"""Step/epoch rate timing, the optional profiler window, and the spans of
the train steps (role of xgan/utils/timer.py).

CUDA work is asynchronous, so on a CUDA device the timer synchronises
before it reads the clock: a rate then covers finished device work, not
the enqueue.

Spans (:func:`span`) mark the phases of a train step. A span is on only
while a ``torch.profiler`` window is open (``maybe_trace``'s, a
benchmark's profiled stretch): it then records its name, its parent (the
enclosing span on its thread), its host start and end on
``time.time_ns()``, a pair of timing CUDA events on the current stream
(where CUDA is initialised) and a ``record_function`` of the same extent,
into :data:`SPANS`. With no window open a span is one shared no-op
context: no event, no record, no allocation.

Inside a CUDA graph capture a span's events are event-record nodes of the
graph (``external=True``), so they hold the times of the graph's last
replay. The K-step dispatcher (:mod:`xgan_torch.train.multistep`)
captures a traced twin of its graph (spans on for that capture alone,
:meth:`SpanBuffer.capture`) and replays it while a window is open; the
plain graph holds no event node. :meth:`SpanBuffer.collect` turns the
records into :class:`Span` tuples, device times in ms from the first
recorded event, after the caller has synchronised.
"""
from __future__ import annotations

import contextlib
import itertools
import json
import os
import threading
import time
from typing import NamedTuple

import torch
from torch.autograd import profiler as _autograd_profiler


class StepTimer:
    def __init__(self, device: torch.device | str = "cpu"):
        self.device = torch.device(device)
        self.reset()

    def _now(self) -> float:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return time.perf_counter()

    def tick(self, n: int = 1):
        now = self._now()
        self.total += now - self.t0
        self.count += n
        self.t0 = now

    @property
    def rate(self) -> float:
        return self.count / self.total if self.total > 0 else 0.0

    def reset(self):
        self.t0 = self._now()
        self.count = 0
        self.total = 0.0


# spans kept per buffer before the rest are only counted (``dropped``)
SPAN_CAP = 100_000
# libkineto's ChromeTraceBaseTime: a Chrome trace's ``ts`` is unix µs less
# the start of the current period of this many seconds
TRACE_BASE_PERIOD_S = 7_889_238


class Span(NamedTuple):
    """One finished span. Host times are None for a span replayed inside
    a CUDA graph (only its events ran), device times None where no CUDA
    event was recorded (the CPU)."""
    name: str
    id: int
    parent: int | None
    host_start_ns: int | None
    host_end_ns: int | None
    device_start_ms: float | None
    device_end_ms: float | None


class _Off:
    """The span of a closed profiler: enters and leaves doing nothing."""
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def split_at_grad(self, tensor, first: str, second: str) -> None:
        pass

    def replays(self, template: list) -> None:
        pass


_OFF = _Off()


def spans_on() -> bool:
    """Whether spans record: a ``torch.profiler`` window is open."""
    return _autograd_profiler._is_profiler_enabled


def span(name: str):
    """``with span(name):`` marks one phase. A shared no-op while no
    profiler window is open and no traced graph is being captured; see
    the module docstring."""
    if not _autograd_profiler._is_profiler_enabled \
            and SPANS._template is None:
        return _OFF
    return SPANS.open(name)


class _Record:
    """A span while it is open, and its record after."""
    __slots__ = ("name", "id", "parent", "t0", "t1", "ev0", "ev1",
                 "template", "_buf", "_rf", "_hook", "_tail")

    def __init__(self, buf: "SpanBuffer", name: str, parent, external):
        self.name = name
        self.id = next(buf._ids)
        self.parent = parent
        self.t0 = self.t1 = None
        self.ev0 = self.ev1 = None
        if external is not None:
            self.ev0 = torch.cuda.Event(enable_timing=True, external=external)
            self.ev1 = torch.cuda.Event(enable_timing=True, external=external)
        self.template = None
        self._buf = buf
        self._rf = self._hook = self._tail = None

    def __enter__(self):
        self._rf = _autograd_profiler.record_function(self.name)
        self._rf.__enter__()
        self._buf._stack().append(self)
        self.t0 = time.time_ns()
        if self.ev0 is not None:
            self.ev0.record()
        return self

    def __exit__(self, exc_type=None, exc=None, tb=None):
        if self.ev1 is not None:
            self.ev1.record()
        self.t1 = time.time_ns()
        if self._tail is not None:
            self._tail.t1, self._tail.ev1 = self.t1, self.ev1
        if self._hook is not None:
            self._hook.remove()
        self._buf._stack().pop()
        self._rf.__exit__(exc_type, exc, tb)
        return False

    def split_at_grad(self, tensor: torch.Tensor, first: str,
                      second: str) -> None:
        """Split this span where the backward reaches ``tensor``'s
        gradient: child ``first`` up to then, child ``second`` after, to
        this span's end. The hook records on the thread that runs the
        backward, so the two children have no ``record_function``."""
        buf = self._buf
        external = self.ev0 is not None and buf._template is not None

        def hook(grad):
            if self._tail is not None:
                return None
            mark = None
            if self.ev0 is not None:
                mark = torch.cuda.Event(enable_timing=True, external=external)
                mark.record()
            t = time.time_ns()
            head = _Record(buf, first, self.id, None)
            head.t0, head.ev0, head.t1, head.ev1 = self.t0, self.ev0, t, mark
            tail = _Record(buf, second, self.id, None)
            tail.t0, tail.ev0 = t, mark
            buf._keep(head)
            buf._keep(tail)
            self._tail = tail
            return None

        self._hook = tensor.register_hook(hook)

    def replays(self, template: list) -> None:
        """This span replayed a CUDA graph whose spans are ``template``."""
        self.template = template


class SpanBuffer:
    """The spans recorded in this process: at most :data:`SPAN_CAP`, then
    only counted in ``dropped``."""

    def __init__(self):
        self.cap = SPAN_CAP
        self.dropped = 0
        self._records: list = []
        self._ids = itertools.count()
        self._local = threading.local()
        self._template = None   # the graph capture's list, while capturing
        self._quiet = False     # a capture that must hold no span

    def _stack(self) -> list:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def _keep(self, rec: _Record) -> None:
        (self._records if self._template is None
         else self._template).append(rec)

    def open(self, name: str):
        if self._quiet:
            return _OFF
        if self._template is None and len(self._records) >= self.cap:
            self.dropped += 1
            return _OFF
        stack = self._stack()
        external = None
        if torch.cuda.is_initialized():
            external = self._template is not None
        rec = _Record(self, name, stack[-1].id if stack else None, external)
        self._keep(rec)
        return rec

    @contextlib.contextmanager
    def capture(self, template: list | None):
        """Around a CUDA graph capture: with ``template`` a list, the
        spans opened meanwhile record there, with event-record nodes,
        whether or not a profiler window is open; with None no span
        records."""
        saved = self._template, self._quiet
        self._template, self._quiet = template, template is None
        try:
            yield
        finally:
            self._template, self._quiet = saved

    def clear(self) -> None:
        self._records = []
        self.dropped = 0

    def collect(self) -> list:
        """The finished spans as :class:`Span` tuples, in the order they
        opened. A graph's spans are read once, under the last span that
        replayed it; they have no host times. Device times are ms from the
        first recorded event; the caller has synchronised the device."""
        last = {}
        for r in self._records:
            if r.template is not None:
                last[id(r.template)] = r
        rows = []
        for r in self._records:
            if r.t1 is None:
                continue
            rows.append((r, r.parent, True))
            if r.template is not None and last[id(r.template)] is r:
                ids = {t.id for t in r.template}
                rows.extend((t, t.parent if t.parent in ids else r.id, False)
                            for t in r.template if t.t1 is not None)
        anchor = next((r.ev0 for r, _, _ in rows if r.ev0 is not None), None)

        def ms(ev):
            return None if ev is None else anchor.elapsed_time(ev)

        return [Span(r.name, r.id, parent, r.t0 if host else None,
                     r.t1 if host else None, ms(r.ev0), ms(r.ev1))
                for r, parent, host in rows]


SPANS = SpanBuffer()


def _union_ms(intervals) -> float:
    total, reach = 0.0, None
    for a, b in sorted(intervals):
        if reach is None or a > reach:
            total += b - a
            reach = b
        elif b > reach:
            total += b - reach
            reach = b
    return total


def self_device_ms(spans: list) -> dict:
    """``{span id: self time}``: a span's device interval less the part of
    it that its children's intervals cover, in ms (spans without device
    times are left out)."""
    kids: dict = {}
    for s in spans:
        if s.parent is not None and s.device_start_ms is not None:
            kids.setdefault(s.parent, []).append(s)
    out = {}
    for s in spans:
        if s.device_start_ms is None:
            continue
        a, b = s.device_start_ms, s.device_end_ms
        covered = _union_ms(
            (max(a, k.device_start_ms), min(b, k.device_end_ms))
            for k in kids.get(s.id, ())
            if k.device_end_ms > a and k.device_start_ms < b)
        out[s.id] = (b - a) - covered
    return out


def trace_us(t_ns: int) -> float:
    """A ``time.time_ns()`` reading on a Chrome trace's clock (the ``ts``
    of ``torch.profiler``'s export, µs): unix µs less libkineto's base,
    the start of the current :data:`TRACE_BASE_PERIOD_S` period."""
    period_ns = TRACE_BASE_PERIOD_S * 1_000_000_000
    return (t_ns - t_ns // period_ns * period_ns) / 1e3


def span_table(spans: list) -> dict:
    """Per span name: calls, host ms, device ms and self device ms, in
    total and per ``step`` span (``steps``; no per-step values without
    one)."""
    own = self_device_ms(spans)
    totals: dict = {}
    for s in spans:
        row = totals.setdefault(s.name, {"calls": 0, "host_ms": 0.0,
                                         "device_ms": None,
                                         "self_device_ms": None})
        row["calls"] += 1
        if s.host_start_ns is not None:
            row["host_ms"] += (s.host_end_ns - s.host_start_ns) / 1e6
        if s.device_start_ms is not None:
            row["device_ms"] = (row["device_ms"] or 0.0) \
                + s.device_end_ms - s.device_start_ms
            row["self_device_ms"] = (row["self_device_ms"] or 0.0) \
                + own[s.id]
    steps = sum(s.name == "step" for s in spans)
    per_step = {name: {k: (None if v is None else v / steps)
                       for k, v in row.items()}
                for name, row in totals.items()} if steps else {}
    return {"steps": steps, "totals": totals, "per_step": per_step}


# tiny kernels that open a trace window on a CUDA device, and the idle
# host seconds after them and before the window closes; see maybe_trace
_TRACE_LEAD_KERNELS = 64
_TRACE_PAD_S = 0.5


@contextlib.contextmanager
def maybe_trace(trace_dir: str | None):
    """A ``torch.profiler`` window (host activity, and the CUDA device's
    when there is one) that writes one Chrome/TensorBoard trace,
    ``<worker>.<time>.pt.trace.json``, into ``trace_dir`` when the window
    closes, also when it closes on an exception; a no-op when
    ``trace_dir`` is empty. A window that recorded spans and closes
    without an exception also writes ``spans.json`` there: its spans, per
    name
    (:func:`span_table`; in a window of CUDA graph replays the spans
    inside the graph are the last step of its last replay).

    On a CUDA device the window opens with ``_TRACE_LEAD_KERNELS`` tiny
    kernels under a ``trace_lead`` annotation, synchronised and followed
    by ``_TRACE_PAD_S`` of idle host time before the traced work, and
    closes ``_TRACE_PAD_S`` after the work has finished. The profiler
    keeps a kernel only if its time, mapped from the device's clock onto
    the host's, lies inside the window, and that mapping can be off by
    milliseconds: without the margins it dropped the head of the traced
    epoch (its first gather among them)."""
    if not trace_dir:
        yield
        return
    from torch.profiler import (ProfilerActivity, profile, record_function,
                                tensorboard_trace_handler)
    cuda = torch.cuda.is_available()
    activities = [ProfilerActivity.CPU]
    if cuda:
        activities.append(ProfilerActivity.CUDA)
        torch.cuda.synchronize()  # the window holds this epoch's work only
    SPANS.clear()
    with profile(activities=activities,
                 on_trace_ready=tensorboard_trace_handler(trace_dir)):
        if cuda:
            with record_function("trace_lead"):
                lead = torch.zeros(1, device="cuda")
                for _ in range(_TRACE_LEAD_KERNELS):
                    lead.add_(1)
                torch.cuda.synchronize()
                time.sleep(_TRACE_PAD_S)
        yield
        if cuda:
            torch.cuda.synchronize()
            time.sleep(_TRACE_PAD_S)
    spans = SPANS.collect()
    if spans or SPANS.dropped:
        with open(os.path.join(trace_dir, "spans.json"), "w") as f:
            json.dump(dict(span_table(spans), dropped=SPANS.dropped), f,
                      indent=1)
