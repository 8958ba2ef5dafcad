#!/usr/bin/env python3
"""On-card check of the PyTorch/CUDA port (``xgan_torch``) on one H100.

    python3 chip_smoke.py

Phases, each of which raises on failure (the script then exits non-zero):

1. the card: ``nvidia-smi`` name and power limit; compute capability 9.0;
2. builds the CUDA kernels from ``xgan_torch/kernels/csrc``;
3. holds each kernel against its plain PyTorch version on the card at the
   shapes the sampler gives it (DCGAN G-224, fg 64, batch 64), in f32 with
   TF32 off and in bf16, and times kernel, plain version and a PyTorch
   library yardstick with CUDA events;
4. runs the sampler through its CLI (``xgan_torch.cli.generate_synthetic``)
   at full width (latent 100, fg 64, 224 px, batch 64, bf16) from a seeded
   random-weight reference-layout ``.pth``: 512 PNGs, each decoded back;
   counts the kernel launches of that run; then holds one f32 batch of the
   kernel path against the plain-version path within 1 u8 level;
5. profiles one sampler batch: 5 ``convt4x4s2`` kernels, no cuDNN conv;
6. prints the kernel table line, the card line and, last, the result line.

Without a CUDA device, or run away from the repo, it exits non-zero and
prints no result.
"""
from __future__ import annotations

import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

B, LATENT, FG, SIZE = 64, 100, 64, 224
NUM_IMAGES = 512
BF16_PEAK_FLOPS = 989e12  # H100 SXM dense bf16 (NVIDIA data sheet)
HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
# f32: the kernel and the plain version sum in different orders (up to
# 4*512 = 2048 products of O(1) values): ~1e-5 absolute; 1e-4 leaves room.
# bf16: both sum in f32 from the same bf16 inputs, but may round the f32
# result to neighbouring bf16 values: two bf16 steps at O(1) is 2**-7.
TOL = {torch.float32: 1e-4, torch.bfloat16: 2 ** -7}


def check(ok: bool, what) -> None:
    """Fail the run (unlike ``assert``, this also holds under ``-O``)."""
    if not ok:
        raise AssertionError(what)


def layer_shapes():
    """(H, Cin, Cout, act) of the five k4s2 layers of the G-224 ladder."""
    widths = [FG * 8, FG * 4, FG * 2, FG, FG // 2, 3]
    h = SIZE // 32
    out = []
    for i in range(5):
        out.append((h, widths[i], widths[i + 1], "relu" if i < 4 else "none"))
        h *= 2
    return out


def time_ms(fn, reps: int = 20, windows: int = 3) -> float:
    """Median over ``windows`` of the mean time of ``reps`` back-to-back
    launches, by CUDA events, after a warm-up."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    means = []
    for _ in range(windows):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        means.append(start.elapsed_time(end) / reps)
    return statistics.median(means)


def phase_card():
    if not torch.cuda.is_available():
        print("Error: chip_smoke.py needs a CUDA device", file=sys.stderr)
        sys.exit(2)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(f"card: {smi}")
    cap = torch.cuda.get_device_capability(0)
    check(cap == (9, 0), f"expected a Hopper card (9, 0), got {cap}")
    return smi


def phase_build():
    from xgan_torch.kernels import build
    t0 = time.perf_counter()
    so = build.build(verbose=True)
    build.load_ops()
    print(f"build: {so.name} ready in {time.perf_counter() - t0:.1f} s")


def phase_kernels():
    """Kernel vs plain version per layer; returns the kernel table entry
    (without ``launches``) for the bf16 main-path shapes."""
    import torch.nn.functional as F
    from xgan_torch.kernels.convt import (convt4x4s2_fused_cuda,
                                          convt4x4s2_fused_ref,
                                          pack_convt_weight)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(1)
    cases = [(h, cin, cout, act, dt) for (h, cin, cout, act) in layer_shapes()
             for dt in (torch.float32, torch.bfloat16)]
    cases.append((28, 128, 64, "leaky_relu", torch.float32))
    total = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "ops_ms": 0.0,
             "bytes_ms": 0.0, "bound_ms": 0.0, "max_abs_err": 0.0}
    for h, cin, cout, act, dt in cases:
        x = torch.randn(B, h, h, cin, generator=g, device=dev).to(dt)
        w = torch.randn(cin, cout, 4, 4, generator=g, device=dev) \
            / math.sqrt(4 * cin)
        scale = torch.rand(cout, generator=g, device=dev) + 0.5
        shift = 0.1 * torch.randn(cout, generator=g, device=dev)
        wp = pack_convt_weight(w, dt)
        got = convt4x4s2_fused_cuda(x, wp, scale, shift, act)
        ref = convt4x4s2_fused_ref(x, wp, scale, shift, act)
        torch.cuda.synchronize()
        check(got.shape == (B, 2 * h, 2 * h, cout) and got.dtype == dt,
              (got.shape, got.dtype))
        err = (got.float() - ref.float()).abs().max().item()
        tol = TOL[dt] * (1 + ref.float().abs().max().item())
        name = f"{h}x{h}x{cin}->{2 * h}x{2 * h}x{cout} {act} {dt}"
        check(err <= tol, f"{name}: max |kernel - plain| {err} > {tol}")
        main_path = dt == torch.bfloat16 and act != "leaky_relu"
        if not main_path:
            print(f"check {name}: max_abs_err {err:.3g} (tol {tol:.3g})")
            continue
        wt = w.to(dt)
        sc4, sh4 = scale.view(1, -1, 1, 1), shift.view(1, -1, 1, 1)
        x_nchw = x.permute(0, 3, 1, 2)  # channels_last view, no copy

        def library():
            y = F.conv_transpose2d(x_nchw, wt, stride=2, padding=1)
            y = y.float() * sc4 + sh4
            return (torch.relu(y) if act == "relu" else y).to(dt)

        ms = time_ms(lambda: convt4x4s2_fused_cuda(x, wp, scale, shift, act))
        plain_ms = time_ms(
            lambda: convt4x4s2_fused_ref(x, wp, scale, shift, act), reps=5)
        library_ms = time_ms(library)
        flops = 2 * B * (2 * h) ** 2 * cout * 4 * cin
        nbytes = (x.numel() + wp.numel() + got.numel()) * x.element_size() \
            + 2 * 4 * cout
        ops_ms = flops / BF16_PEAK_FLOPS * 1e3
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        bound_ms = max(ops_ms, bytes_ms)
        print(f"layer {name}: max_abs_err {err:.3g} (tol {tol:.3g}); "
              f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
              f"conv_transpose2d+affine+act {library_ms:.4f} ms; "
              f"{flops / 1e9:.3f} GFLOP, {nbytes / 1e6:.3f} MB, "
              f"bound {bound_ms:.4f} ms "
              f"({'operations' if ops_ms >= bytes_ms else 'bytes'}), "
              f"{flops / ms / 1e9:.1f} TFLOP/s")
        for k, v in (("ms", ms), ("plain_ms", plain_ms),
                     ("library_ms", library_ms), ("ops_ms", ops_ms),
                     ("bytes_ms", bytes_ms), ("bound_ms", bound_ms)):
            total[k] += v
        total["max_abs_err"] = max(total["max_abs_err"], err)
    return {
        "name": "convt4x4s2_fused", "route": "cuda",
        "source": "xgan_torch/kernels/csrc/convt4x4s2.cu",
        "replaces": "xgan/ops/pallas/convt.py:101",
        "launches": 0, "max_abs_err": total["max_abs_err"],
        "ms": total["ms"], "plain_ms": total["plain_ms"],
        "bound_ms": total["bound_ms"],
        "bound_by": ("operations" if total["ops_ms"] >= total["bytes_ms"]
                     else "bytes"),
        "library_ms": total["library_ms"],
    }


def random_generator_pth(path: str):
    """Seeded random weights in the reference layout, scaled so every layer
    keeps unit gain (the images then span the u8 range), with random BN
    running statistics."""
    from xgan_torch.models.dcgan import SEQ_BN, SEQ_CONVT, Generator
    g = torch.Generator().manual_seed(0)
    model = Generator(LATENT, 3, FG, SIZE, generator=g)
    sd = model.state_dict()
    for seq in SEQ_CONVT:
        w = sd[f"main.{seq}.weight"]
        fan = w.shape[0] * (1 if seq == 0 else 4)
        sd[f"main.{seq}.weight"] = torch.randn(w.shape, generator=g) \
            * math.sqrt(2.0 / fan)
    for seq in SEQ_BN:
        c = sd[f"main.{seq}.weight"].shape[0]
        sd[f"main.{seq}.weight"] = 1 + 0.1 * torch.randn(c, generator=g)
        sd[f"main.{seq}.bias"] = 0.1 * torch.randn(c, generator=g)
        sd[f"main.{seq}.running_mean"] = 0.1 * torch.randn(c, generator=g)
        sd[f"main.{seq}.running_var"] = 0.5 + torch.rand(c, generator=g)
    torch.save(sd, path)


def phase_sampler(tmp: str):
    """The main path: the CLI at full width. Returns its launch counts and
    the median rate of three more, warm runs (the first includes one-time
    set-up such as the CUDA libraries' handles)."""
    from xgan_torch import kernels
    from xgan_torch.cli.generate_synthetic import main as sample_main
    from xgan_torch.data.pipeline import tanh_to_u8
    from xgan_torch.kernels.convt import convt4x4s2_fused_ref
    from xgan_torch.models.convert import load_generator_pth
    from xgan_torch.models.dcgan import Generator
    from xgan_torch.native.png import decode_png

    pth = os.path.join(tmp, "generator.pth")
    random_generator_pth(pth)

    def run(out_dir):
        stats = sample_main([
            "--model-path", pth, "--output-dir", out_dir,
            "--num-images", str(NUM_IMAGES), "--latent-dim", str(LATENT),
            "--feature-maps-g", str(FG), "--image-size", str(SIZE),
            "--batch-size", str(B), "--compute-dtype", "bf16", "--seed", "0"])
        torch.cuda.synchronize()
        print(f"sampler: {stats['written']} images, "
              f"{stats['imgs_per_sec']:.1f} imgs/s written, "
              f"{stats['device_plus_transfer_imgs_per_sec']:.1f} imgs/s "
              "device+transfer")
        return stats

    out_dir = os.path.join(tmp, "synthetic")
    kernels.reset_launch_counts()
    run(out_dir)
    launches = dict(kernels.LAUNCHES)
    print(f"sampler launches: {launches}")
    want = 5 * math.ceil(NUM_IMAGES / B)
    check(launches.get("convt4x4s2_fused", 0) == want, (launches, want))
    rates = [run(os.path.join(tmp, "synthetic_warm"))["imgs_per_sec"]
             for _ in range(3)]
    print(f"sampler warm runs: {', '.join(f'{r:.1f}' for r in rates)} "
          f"imgs/s written, median {statistics.median(rates):.1f}")

    files = sorted(os.listdir(out_dir))
    check(files == [f"synthetic_{i:05d}.png"
                    for i in range(1, NUM_IMAGES + 1)], files[:3])
    first = []
    for i, name in enumerate(files):
        img = decode_png(os.path.join(out_dir, name))
        check(img.shape == (SIZE, SIZE, 3), (name, img.shape))
        if i < B:
            first.append(img)
    first = torch.from_numpy(np.stack(first))

    # One f32 batch: kernel path vs plain-version path, on the card, with
    # the z the CLI drew for its first batch.
    sd = load_generator_pth(pth)
    g32 = Generator(LATENT, 3, FG, SIZE, dtype=torch.float32, device="cuda")
    g32.load_state_dict(sd)
    z = torch.randn((B, LATENT), device="cuda",
                    generator=torch.Generator("cuda").manual_seed(0))
    u8_kernel = tanh_to_u8(g32(z))
    u8_plain = tanh_to_u8(g32(z, convt=convt4x4s2_fused_ref))
    d = (u8_kernel.int() - u8_plain.int()).abs()
    print(f"f32 batch kernel vs plain: max {d.max().item()} u8 levels, "
          f"{(d > 0).float().mean().item():.3g} of pixels differ")
    check(d.max().item() <= 1, "f32 kernel path vs plain path > 1 level")
    # bf16 CLI output vs the f32 kernel path for the same z
    d16 = (first.int() - u8_kernel.cpu().int()).abs().float()
    print(f"bf16 CLI batch vs f32: mean {d16.mean().item():.3f}, "
          f"max {d16.max().item():.0f} u8 levels; image std "
          f"{first.float().std().item():.1f} levels")
    check(d16.mean().item() <= 2.0, "bf16 images far from the f32 ones")
    return launches, statistics.median(rates)


def phase_profile():
    """One sampler batch under torch.profiler: 5 convt4x4s2 kernels and no
    cuDNN convolution; prints the device-time breakdown."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from xgan_torch.data.pipeline import tanh_to_u8
    from xgan_torch.models.dcgan import Generator
    model = Generator(LATENT, 3, FG, SIZE, dtype=torch.bfloat16,
                      device="cuda")
    z = torch.randn(B, LATENT, device="cuda")
    tanh_to_u8(model(z))
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        tanh_to_u8(model(z))
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    ours = [e for e in kernels if "convt4x4s2" in e.name]
    conv = [e.name for e in kernels if "convt4x4s2" not in e.name
            and ("cudnn" in e.name.lower() or "conv" in e.name.lower())]
    busy_ms = sum(e.device_time for e in kernels) / 1e3
    ours_ms = sum(e.device_time for e in ours) / 1e3
    print(f"profile of one batch: {len(kernels)} kernels, {busy_ms:.3f} ms "
          f"device time ({ours_ms:.3f} ms in {len(ours)} convt4x4s2), "
          f"{wall_ms:.3f} ms wall under the profiler")
    top = sorted(prof.key_averages(),
                 key=lambda e: -e.self_device_time_total)
    for e in top[:8]:
        if e.self_device_time_total > 0:
            print(f"  {e.self_device_time_total / 1e3:9.3f} ms  "
                  f"x{e.count:<3d} {e.key[:90]}")
    check(len(ours) == 5, [e.name for e in kernels])
    check(not conv, conv)
    return busy_ms


def main():
    smi = phase_card()
    phase_build()
    entry = phase_kernels()
    with tempfile.TemporaryDirectory(prefix="xgan_chip_smoke_") as tmp:
        launches, warm_rate = phase_sampler(tmp)
    busy_ms = phase_profile()
    loop_ms_per_batch = B / warm_rate * 1e3
    print(f"sampler loop: {loop_ms_per_batch:.2f} ms per batch of {B} "
          f"(warm median) vs {busy_ms:.3f} ms profiled device time per "
          f"batch: device idle share ~{1 - busy_ms / loop_ms_per_batch:.3f}")
    entry["launches"] = launches["convt4x4s2_fused"]
    print(json.dumps({"kernels": [entry]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
