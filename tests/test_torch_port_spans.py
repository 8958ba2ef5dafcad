"""The spans of xgan_torch's train steps (``xgan_torch.utils.timer``) and
the benchmark's readers of them (``bench_port/spans.py``,
``bench_port/metrics/*_ms.py``).

On the CPU: a span is a shared no-op with no profiler window open (no
record, no CUDA event, under a microsecond); under a CPU
``torch.profiler`` window the DCGAN and WGAN-GP steps, their
``--grad-accum`` forms, the data-parallel path and the K-step dispatcher
record their phases by name, parent and order; each host interval lies
inside its ``record_function`` event on the trace's clock; the self-time
arithmetic, ``maybe_trace``'s ``spans.json`` and every reader on a
hand-built stretch. Marked ``cuda`` (they skip here; run on the card with
``python -m pytest --noconftest tests/test_torch_port_spans.py -q -m
cuda``): the traced twin of a K-step graph computes what the plain graph
computes, bitwise; the plain graph holds no event node; a step's phases
tile its ``step`` span.
"""
import json
import os
import tempfile
import timeit
import types

import pytest
import torch
import torch.distributed as dist
from torch.profiler import ProfilerActivity, profile

from bench_port import spans as bspans
from bench_port import trace
from bench_port.metrics import (adam_ms, backward_ms, data_ms, dp_sync_ms,
                                forward_ms, host_wait_ms)
from xgan_torch.models import dcgan as dcgan_models
from xgan_torch.models import wgan as wgan_models
from xgan_torch.train.common import adam
from xgan_torch.train.gan import dcgan_step
from xgan_torch.train.multistep import StepsPerCall
from xgan_torch.train.wgan import wgan_step
from xgan_torch.utils import timer
from xgan_torch.utils.timer import SPANS, Span, maybe_trace, span

torch.set_num_threads(1)

LATENT, FM, SIZE, B = 8, 8, 32, 4
DCGAN = ["step", "data", "g_forward", "d_forward", "d_backward", "adam_d",
         "g_loss_forward", "g_backward", "d_input_grad", "g_param_grad",
         "adam_g", "metrics"]


def _dcgan(dev="cpu", dtype=torch.float32, size=SIZE, fm=FM):
    torch.manual_seed(0)
    g = dcgan_models.Generator(LATENT, 3, fm, size, dtype=dtype, device=dev)
    d = dcgan_models.Discriminator(3, fm, size, dtype=dtype, device=dev)
    cap = torch.device(dev).type == "cuda"
    return g, d, adam(g.parameters(), 2e-4, 0.5, capturable=cap), \
        adam(d.parameters(), 2e-4, 0.5, capturable=cap)


def _store(n=16, dev="cpu", size=SIZE):
    gen = torch.Generator().manual_seed(1)
    return torch.randint(0, 255, (n, size, size, 3), dtype=torch.uint8,
                         generator=gen).to(dev)


def _traced(fn):
    """Run ``fn`` under a CPU profiler window; its spans, and the window's
    Chrome trace events."""
    SPANS.clear()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "t.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    return SPANS.collect(), events


def _tree(spans):
    names = {s.id: s.name for s in spans}
    return [(s.name, names.get(s.parent)) for s in spans]


def test_off_records_nothing_and_makes_no_event(monkeypatch):
    def no_event(*a, **k):
        raise AssertionError("a CUDA event was made")
    monkeypatch.setattr(torch.cuda, "Event", no_event)
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    SPANS.clear()
    assert span("step") is timer._OFF
    g, d, og, od = _dcgan()
    dcgan_step(g, d, og, od, _store(), torch.arange(B), latent_dim=LATENT,
               generator=torch.Generator().manual_seed(0))
    assert SPANS.collect() == [] and SPANS.dropped == 0


def test_off_span_costs_under_a_microsecond():
    best = min(timeit.repeat("with span('step'): pass",
                             globals={"span": span}, number=20000,
                             repeat=7)) / 20000
    assert best < 1e-6, best


@pytest.mark.parametrize("accum", [1, 2])
def test_dcgan_step_spans(accum):
    g, d, og, od = _dcgan()
    spans, _ = _traced(lambda: dcgan_step(
        g, d, og, od, _store(), torch.arange(B), latent_dim=LATENT,
        generator=torch.Generator().manual_seed(0), grad_accum=accum))
    if accum == 1:
        want = _tree_of_dcgan()
    else:
        d_mb = [("g_forward", "step"), ("d_forward", "step"),
                ("d_backward", "step"), ("metrics", "step")]
        g_mb = [("g_forward", "step"), ("g_loss_forward", "step"),
                ("g_backward", "step"), ("d_input_grad", "g_backward"),
                ("g_param_grad", "g_backward"), ("metrics", "step")]
        want = [("step", None), ("data", "step"), *d_mb, *d_mb,
                ("adam_d", "step"), *g_mb, *g_mb, ("adam_g", "step"),
                ("metrics", "step")]
    assert _tree(spans) == want
    assert all(s.device_start_ms is None for s in spans)


@pytest.mark.parametrize("accum", [1, 2])
def test_wgan_step_spans(accum):
    torch.manual_seed(0)
    g = wgan_models.Generator(LATENT, 3, FM, SIZE)
    c = wgan_models.Critic(3, FM, SIZE)
    og, oc = adam(g.parameters(), 2e-4, 0.5, 0.9), \
        adam(c.parameters(), 2e-4, 0.5, 0.9)
    spans, _ = _traced(lambda: wgan_step(
        g, c, og, oc, _store(), torch.arange(B), latent_dim=LATENT,
        critic_iters=2, lambda_gp=10.0,
        generator=torch.Generator().manual_seed(0), grad_accum=accum))
    critic = [("g_forward", "step"), ("critic_forward", "step"),
              ("gradient_penalty", "step"), ("critic_backward", "step")]
    gen = [("g_forward", "step"), ("g_loss_forward", "step"),
           ("g_backward", "step"), ("d_input_grad", "g_backward"),
           ("g_param_grad", "g_backward")]
    update = critic * accum + [("adam_c", "step")]
    want = [("step", None), ("data", "step"), *update, *update,
            *gen * accum, ("adam_g", "step")]
    assert _tree(spans) == want


def test_data_parallel_step_spans_sync_and_moments():
    from bench_port.programs.common import join_one_rank, leave_group
    from xgan_torch.models.layers import sync_batch_norm
    mesh = join_one_rank(torch.device("cpu"))
    try:
        g, d, og, od = _dcgan()
        sync_batch_norm(g, mesh)
        sync_batch_norm(d, mesh)
        spans, _ = _traced(lambda: dcgan_step(
            g, d, og, od, _store(), torch.arange(B), latent_dim=LATENT,
            generator=torch.Generator().manual_seed(0), mesh=mesh))
    finally:
        leave_group()
    assert not dist.is_initialized()
    tree = _tree(spans)
    top = [n for n, parent in tree if parent == "step"]
    assert top == ["data", "g_forward", "d_forward", "d_backward", "dp_sync",
                   "adam_d", "g_loss_forward", "g_backward", "dp_sync",
                   "adam_g", "metrics"]
    moments = [parent for n, parent in tree if n == "bn_moments"]
    # G's BN layers once, D's on the real and the fake batch, then on fake
    n_g = sum(isinstance(m, torch.nn.BatchNorm2d) for m in g.modules())
    n_d = sum(isinstance(m, torch.nn.BatchNorm2d) for m in d.modules())
    assert moments == ["g_forward"] * n_g + ["d_forward"] * 2 * n_d \
        + ["g_loss_forward"] * n_d


def test_dispatcher_on_the_cpu_records_its_k_steps():
    g, d, og, od = _dcgan()
    store, gen = _store(), torch.Generator().manual_seed(0)
    multi = StepsPerCall(lambda idx: dcgan_step(
        g, d, og, od, store, idx, latent_dim=LATENT, generator=gen), 2, gen)
    spans, _ = _traced(lambda: multi(torch.arange(2 * B).reshape(2, B)))
    assert _tree(spans) == [t for _ in range(2) for t in _tree_of_dcgan()]


def _tree_of_dcgan():
    return [(n, None if n == "step" else "g_backward"
             if n in ("d_input_grad", "g_param_grad") else "step")
            for n in DCGAN]


def test_host_span_lies_inside_its_record_function():
    g, d, og, od = _dcgan()
    spans, events = _traced(lambda: dcgan_step(
        g, d, og, od, _store(), torch.arange(B), latent_dim=LATENT,
        generator=torch.Generator().manual_seed(0)))
    marks = {}
    for e in events:
        if e.get("ph") == "X" and e.get("cat") == "user_annotation":
            marks.setdefault(e["name"], []).append(
                (float(e["ts"]), float(e["ts"]) + float(e["dur"])))
    checked = 0
    for s in spans:
        if s.name in ("d_input_grad", "g_param_grad"):
            continue  # split by a hook: no record_function of their own
        a = timer.trace_us(s.host_start_ns)
        b = timer.trace_us(s.host_end_ns)
        assert any(r0 <= a + 1e-3 and b <= r1 + 1e-3
                   for r0, r1 in marks[s.name]), (s.name, a, b)
        checked += 1
    assert checked == len(DCGAN) - 2


def _span(name, i, parent, dev, host=None):
    h0, h1 = host if host is not None else (None, None)
    return Span(name, i, parent, h0, h1, *dev)


def test_self_time_takes_out_what_children_cover():
    spans = [_span("step", 0, None, (0.0, 10.0)),
             _span("a", 1, 0, (1.0, 4.0)),
             _span("b", 2, 0, (3.0, 6.0)),     # overlaps a: counted once
             _span("c", 3, 2, (3.5, 4.5)),
             _span("d", 4, 0, (9.0, 12.0)),    # clipped at the parent's end
             _span("host", 5, 0, (None, None))]
    own = timer.self_device_ms(spans)
    assert own == pytest.approx({0: 10 - 5 - 1, 1: 3, 2: 2, 3: 1, 4: 3})
    table = timer.span_table(spans)
    assert table["steps"] == 1
    assert table["totals"]["b"]["self_device_ms"] == pytest.approx(2)
    assert table["per_step"]["a"]["device_ms"] == pytest.approx(3)
    assert table["totals"]["host"]["device_ms"] is None


def test_trace_clock_subtracts_libkinetos_base():
    period = timer.TRACE_BASE_PERIOD_S
    t = (5 * period + 12) * 10 ** 9 + 345_678
    assert timer.trace_us(t) == pytest.approx(12e6 + 345.678)


def test_buffer_counts_what_it_drops(monkeypatch):
    monkeypatch.setattr(SPANS, "cap", 3)
    spans, _ = _traced(lambda: [span(str(i)).__enter__().__exit__()
                                for i in range(5)])
    assert [s.name for s in spans] == ["0", "1", "2"]
    assert SPANS.dropped == 2
    SPANS.clear()


def test_maybe_trace_writes_the_span_table(tmp_path):
    g, d, og, od = _dcgan()
    with maybe_trace(str(tmp_path)):
        for t in range(2):
            dcgan_step(g, d, og, od, _store(), torch.arange(B) + t,
                       latent_dim=LATENT,
                       generator=torch.Generator().manual_seed(t))
    table = json.loads((tmp_path / "spans.json").read_text())
    assert table["steps"] == 2 and table["dropped"] == 0
    assert set(table["totals"]) == set(DCGAN)
    assert table["totals"]["adam_d"]["calls"] == 2
    assert table["per_step"]["adam_d"]["calls"] == 1
    assert table["per_step"]["data"]["host_ms"] > 0
    assert table["per_step"]["data"]["device_ms"] is None
    assert len(list(tmp_path.glob("*.pt.trace.json"))) == 1


# the readers, on a hand-built stretch: the trace's clock in µs, spans'
# host times in ns on the same clock (base 0), device times in ms
BASE_NS = 3 * timer.TRACE_BASE_PERIOD_S * 10 ** 9


def _ns(us):
    return BASE_NS + int(us * 1e3)


def _stretch(gaps_us, start=1000.0, end=21000.0, steps=2):
    """A stretch whose device events leave ``gaps_us`` idle."""
    device, at = [], start
    for a, b in gaps_us:
        device.append(("k", "kernel", at, a))
        at = b
    device.append(("k", "kernel", at, end))
    return trace.Stretch(device, [], start, end, steps)


def _two_steps():
    """Two eager steps of 10 ms on the device, each: data 1, g_forward 2
    (a bn_moments of 0.5 inside), d_backward 4, dp_sync 1, adam_d 1.5, and
    0.5 ms of its own."""
    out, i = [], 0
    for k in range(2):
        t0 = 10.0 * k
        h0 = 900.0 + 10_000 * k
        step = i
        out.append(_span("step", i, None, (t0, t0 + 10),
                         (_ns(h0), _ns(h0 + 9_000))))
        i += 1
        at = t0
        for name, ms in (("data", 1), ("g_forward", 2), ("d_backward", 4),
                         ("dp_sync", 1), ("adam_d", 1.5)):
            host = (_ns(h0 + 900 * (at - t0)),
                    _ns(h0 + 900 * (at - t0 + ms)))
            out.append(_span(name, i, step, (at, at + ms), host))
            if name == "g_forward":
                out.append(_span("bn_moments", i + 1, i, (at + 1, at + 1.5),
                                 (host[0] + 500_000, host[0] + 900_000)))
                i += 1
            i += 1
            at += ms
    return out


READERS = [(data_ms, 1.0), (forward_ms, 1.5), (backward_ms, 4.0),
           (adam_ms, 1.5), (dp_sync_ms, 1.5)]


@pytest.fixture
def collected(monkeypatch):
    """Make the program's collect() return a given span list."""
    def use(spans):
        monkeypatch.setattr(SPANS, "collect", lambda: list(spans))
    return use


@pytest.mark.parametrize("reader,want", READERS,
                         ids=[r.__name__.rsplit(".", 1)[1]
                              for r, _ in READERS])
def test_phase_readers_sum_self_time_per_step(collected, reader, want):
    collected(_two_steps())
    ctx = types.SimpleNamespace(stretch=_stretch([]))
    assert reader.read(ctx) == pytest.approx(want)


def test_phases_and_the_steps_own_time_make_the_step(collected):
    collected(_two_steps())
    ctx = types.SimpleNamespace(stretch=_stretch([]))
    parts = sum(r.read(ctx) for r, _ in READERS)
    own = bspans.per_step_ms(ctx.stretch, ("step",))
    assert parts + own == pytest.approx(10.0)


def test_host_wait_goes_to_the_innermost_span(collected):
    collected(_two_steps())
    # step 0's host: 900 .. 9900 µs; its g_forward 1800 .. 3600 with
    # bn_moments 2300 .. 2700; step 1 from 10900, its data to 11800
    gaps = [(2400.0, 2600.0),      # middle in bn_moments
            (3000.0, 3400.0),      # in g_forward
            (9950.0, 10850.0),     # between the steps: in no span
            (11000.0, 11100.0)]    # step 1's data
    st = _stretch(gaps)
    idle = bspans.idle_by_span(st)
    assert idle == pytest.approx({"bn_moments": 200.0, "g_forward": 400.0,
                                  None: 900.0, "data": 100.0})
    ctx = types.SimpleNamespace(stretch=st)
    assert host_wait_ms.read(ctx) == pytest.approx(0.7 / 2)


def test_readers_read_nothing_without_spans(collected, monkeypatch):
    ctx = types.SimpleNamespace(stretch=_stretch([(2000.0, 2100.0)]))
    collected([])
    for reader, _ in READERS + [(host_wait_ms, None)]:
        assert reader.read(ctx) is None
    # spans, but all before the stretch: nothing of it
    collected([_span("step", 0, None, (0.0, 1.0), (_ns(0), _ns(500)))])
    assert data_ms.read(ctx) is None and host_wait_ms.read(ctx) is None
    # a step without the phase asked for
    collected([_span("step", 0, None, (0.0, 1.0), (_ns(900), _ns(5000)))])
    assert dp_sync_ms.read(ctx) is None
    # a program without spans (the module lacks them)
    collected(_two_steps())
    monkeypatch.delattr(timer, "SPANS")
    for reader, _ in READERS + [(host_wait_ms, None)]:
        assert reader.read(ctx) is None


def test_graph_spans_hang_under_the_last_replay():
    """Spans captured into a template are read once, under the last span
    that replayed it, without host times."""
    buf = timer.SpanBuffer()
    template = []
    with profile(activities=[ProfilerActivity.CPU]):
        with buf.capture(template):
            rec = buf.open("step")
            with rec:
                with buf.open("data"):
                    pass
        for _ in range(2):
            with buf.open("replay") as r:
                r.replays(template)
    spans = buf.collect()
    assert _tree(spans) == [("replay", None), ("replay", None),
                            ("step", "replay"), ("data", "step")]
    assert spans[2].parent == spans[1].id
    assert spans[2].host_start_ns is None and spans[0].host_start_ns


def test_a_quiet_capture_records_no_span():
    buf = timer.SpanBuffer()
    with profile(activities=[ProfilerActivity.CPU]):
        with buf.capture(None):
            assert buf.open("step") is timer._OFF
    assert buf.collect() == []


# --- on the card -----------------------------------------------------

@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    return torch.device("cuda")


def _k_step(dev, k=2, size=64, fm=16):
    """A bf16 DCGAN at K steps a call on the card (64 px and 16 features
    unless given), on a 64-row store."""
    g, d, og, od = _dcgan(dev, torch.bfloat16, size=size, fm=fm)
    store = _store(64, dev, size=size)
    gen = torch.Generator(dev).manual_seed(0)
    multi = StepsPerCall(lambda idx: dcgan_step(
        g, d, og, od, store, idx, latent_dim=LATENT, dtype=torch.bfloat16,
        generator=gen), k, gen)
    return multi, g, d


def _rows(call, k=2, b=16):
    return (torch.arange(k * b, device="cuda").reshape(k, b) + 7 * call) % 64


def _profiled_kernels(fn):
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(e.device_type == torch.autograd.DeviceType.CUDA
               for e in prof.events())


@pytest.mark.cuda
def test_twin_computes_what_the_plain_graph_computes(dev):
    outs = []
    for traced in (False, False, True):
        multi, g, d = _k_step(dev)
        multi(_rows(0))                  # eager
        multi(_rows(1))                  # captures both, replays the plain
        if traced:
            multi(_rows(2))
            SPANS.clear()
            with profile(activities=[ProfilerActivity.CUDA]):
                got = multi(_rows(3))    # the twin
            assert [s.name for s in SPANS.collect()][:2] == ["replay",
                                                            "step"]
        else:
            multi(_rows(2))
            got = multi(_rows(3))
        torch.cuda.synchronize()
        outs.append((got.float().cpu(),
                     [p.detach().float().cpu() for p in g.parameters()]))
    (m0, p0), (m1, p1), (m2, p2) = outs
    assert torch.equal(m0, m1) and all(map(torch.equal, p0, p1)), \
        "two plain runs differ: the card is not deterministic here"
    assert torch.equal(m0, m2)
    assert all(map(torch.equal, p0, p2))


@pytest.mark.cuda
def test_plain_graph_holds_no_event_node(dev):
    multi, _, _ = _k_step(dev)
    multi(_rows(0))
    multi(_rows(1))                      # captures both graphs
    torch.cuda.synchronize()
    plain = _profiled_kernels(multi.graph.replay)
    twin = _profiled_kernels(multi._twin[0].replay)
    assert plain == twin > 0
    SPANS.clear()
    for t in range(3):
        multi(_rows(3 + t))
    torch.cuda.synchronize()
    assert SPANS.collect() == []


@pytest.mark.cuda
@pytest.mark.parametrize("graph", [False, True], ids=["eager", "graph"])
def test_phases_tile_the_step(dev, graph):
    # a cell's step (224 px, 64 features, B = 128): each span boundary
    # holds the card some µs, which a 64 px step of 4 ms would feel
    multi, _, _ = _k_step(dev, size=224, fm=64)
    call = multi if graph else lambda rows: multi.step(rows[0])
    for t in range(2):
        call(_rows(t, b=128))
    SPANS.clear()
    with profile(activities=[ProfilerActivity.CUDA]):
        # the card busy for ~1 s while the host queues the steps: the
        # device then never waits on the host inside a step (that wait is
        # host_wait_ms's), and the step's phases tile it
        torch.cuda._sleep(2 * 10 ** 9)
        for t in range(3):
            call(_rows(2 + t, b=128))
        torch.cuda.synchronize()
    spans = SPANS.collect()
    steps = [s for s in spans if s.name == "step"]
    assert len(steps) == (1 if graph else 3)   # a graph: its last step
    for step in steps:
        kids = [s for s in spans if s.parent == step.id]
        parts = sum(s.device_end_ms - s.device_start_ms for s in kids)
        whole = step.device_end_ms - step.device_start_ms
        assert abs(parts - whole) <= 0.03 * whole, (
            parts, whole, [(s.name, s.device_start_ms, s.device_end_ms)
                           for s in [step, *kids]])
