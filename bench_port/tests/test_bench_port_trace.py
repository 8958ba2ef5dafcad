"""The reduction of a profile to the stretch's events, and the per-layer
readers, on a made-up Chrome trace."""
import pytest

from bench_port import catalog, flops, harness, trace


def _ev(name, cat, ts, dur):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur}


def _trace():
    lead = [_ev("fill", "kernel", 100.0 + i, 0.5) for i in range(4)]
    t0 = 1_000_000.0  # after the half-second pad
    body = [
        _ev("convt4x4s2_wgmma_kernel", "kernel", t0, 100.0),
        _ev("gemm", "kernel", t0 + 150.0, 50.0),           # 50 idle before
        _ev("Memcpy HtoD", "gpu_memcpy", t0 + 190.0, 20.0),  # overlaps gemm
        _ev("convt4x4s2_band_kernel", "kernel", t0 + 300.0, 100.0),
    ]
    host = [
        _ev("cudaLaunchKernel", "cuda_runtime", t0 + 110.0, 30.0),
        _ev("cudaLaunchKernel", "cuda_runtime", t0 + 95.0, 4.0),
    ]
    return lead + body + host + [{"ph": "i", "name": "marker"}], t0


def test_stretch_after_the_pad():
    events, t0 = _trace()
    st = trace.reduce(events, steps=2)
    assert (st.start_us, st.end_us) == (t0, t0 + 400.0)
    assert len(st.kernels()) == 3 and len(st.device) == 4
    assert trace.busy_us(st) == pytest.approx(100.0 + 60.0 + 100.0)
    assert trace.idle_gaps(st) == [(t0 + 100.0, t0 + 150.0),
                                   (t0 + 210.0, t0 + 300.0)]
    bd = trace.breakdown(st)
    assert bd["device_ops"][0][0].startswith("convt4x4s2")
    assert dict(bd["idle_gaps"]) == pytest.approx(
        {"cudaLaunchKernel": 50e-6, trace.NO_HOST_EVENT: 90e-6})


def test_no_pad_is_an_error():
    with pytest.raises(RuntimeError):
        trace.reduce([_ev("k", "kernel", 0.0, 1.0)], 1)


def test_readers_on_the_made_up_stretch():
    events, _ = _trace()
    st = trace.reduce(events, steps=2)
    cfg, cell = harness.load("dcgan224-b128-k4")
    peaks = {"flops": 989e12, "bytes_per_s": 3.35e12}
    ctx = harness.Context(cfg=cfg, cell=cell, peaks=peaks, window_s=1.0,
                          window_steps=50, stretch=st,
                          busy_us=trace.busy_us(st),
                          data=catalog.metric_data("convt_roofline"))
    read = {m: catalog.metric(m).read(ctx) for m in
            ("step_mfu", "kernels_per_step", "device_idle_share",
             "convt_roofline")}
    assert read["kernels_per_step"] == 1.5
    assert read["device_idle_share"] == pytest.approx(100 * 140 / 400)
    assert read["step_mfu"] == pytest.approx(
        100 * flops.step(cfg, 128) * 50 / 989e12)
    bound = flops.convt_bound_s(cfg, 128, peaks) * 2
    assert read["convt_roofline"] == pytest.approx(100 * bound / 200e-6)
    # nothing to read: no matching kernel, a card not in the table
    ctx.data = {"kernel_name_contains": ["no_such_kernel"]}
    assert catalog.metric("convt_roofline").read(ctx) is None
    ctx.peaks = None
    assert catalog.metric("step_mfu").read(ctx) is None
