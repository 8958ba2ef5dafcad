#!/usr/bin/env python3
"""On-card check of the PyTorch/CUDA port (``xgan_torch``) on one H100.

    python3 chip_smoke.py

Phases, each of which raises on failure (the script then exits non-zero):

1. the card: ``nvidia-smi`` name and power limit; compute capability 9.0;
2. builds the CUDA kernels from ``xgan_torch/kernels/csrc``; prints what
   ``ptxas -v`` says of each instantiation of the tensor-core ConvT kernel
   (``convt4x4s2_mma``) and checks that none spills, and that its SASS
   (``cuobjdump -sass``) holds ``HMMA`` tensor-core instructions;
3. holds each ConvT route against its plain PyTorch version on the card at
   the shapes the sampler gives it (DCGAN G-224, fg 64, batch 64): f32
   with TF32 off on the CUDA-core kernel, bf16 on the tensor-core kernel,
   plus bf16 cases the ladder lacks (ragged M, H != W, Cout = 40, leaky
   ReLU); times per bf16 layer the kernel, the CUDA-core kernel on the
   same bf16 inputs, the plain version and a PyTorch library yardstick
   with CUDA events;
4. runs the sampler through its CLI (``xgan_torch.cli.generate_synthetic``)
   at full width (latent 100, fg 64, 224 px, batch 64, bf16) from a seeded
   random-weight reference-layout ``.pth``: 512 PNGs, each decoded back;
   counts the kernel launches of that run (40, all on the tensor-core
   route); then holds one f32 batch of the kernel path against the
   plain-version path within 1 u8 level, and the bf16 batch against it;
5. profiles one sampler batch: 5 ``convt4x4s2`` kernels, no cuDNN conv;
6. holds the ``mixed_gather`` kernel bitwise against its plain version on
   the card (a 4,096-image real and a 1,024-image synthetic u8 store at
   224 px; B = 32 mixed, all real, all synthetic; B = 256 for a bandwidth
   reading; a bad index must raise) and times it, its plain version and
   the ``torch.where`` yardstick, each timed call on the next of 32 index
   sets so that its rows come from HBM, not from the L2 cache;
7. writes an RSNA-layout tree (512 train and 128 test PNGs at 256 px)
   with the port's encoder, times the store build (decode + resize to
   224), and trains the classifier through its CLI
   (``xgan_torch.cli.train_classifier``) at full width (ResNet-50
   (3,4,6,3), 224 px, B = 32, bf16) on it, with the sampler's 512 PNGs
   as the synthetic set: run A curriculum, 2 folds x 2 epochs, frozen
   base; run B augmented, one run of 1 epoch, ``--unfreeze``. It checks
   the JSON files and the checkpoints, that ``mixed_gather`` launched
   once per train step and never in validation or test, and that one f32
   train step through the kernel and through the plain gather gives the
   same u8 batch and the same loss;
8. times and profiles warm train steps of both runs' configurations: ms
   per step, imgs/s, the top device ops, one ``mixed_gather`` kernel per
   step, the device idle share;
9. prints the kernel table line, the card line and, last, the result line.

Without a CUDA device, or run away from the repo, it exits non-zero and
prints no result.
"""
from __future__ import annotations

import itertools
import json
import math
import os
import re
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

B, LATENT, FG, SIZE = 64, 100, 64, 224
NUM_IMAGES = 512
CLS_B = 32  # the classifier's batch (src/train_classifier.py default)
N_TRAIN, N_TEST, RAW_SIZE = 512, 128, 256  # the classifier's data tree
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


MMA_KERNEL = "convt4x4s2_mma_kernel"


def ptxas_report(log: str) -> dict:
    """Per entry function of a ``ptxas -v`` log: registers, stack frame
    and spill bytes."""
    out, name = {}, None
    for line in log.splitlines():
        if m := re.search(r"Compiling entry function '(\S+)'", line):
            name = m.group(1)
            out[name] = {}
        elif name and (m := re.search(
                r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                r"(\d+) bytes spill loads", line)):
            out[name].update(stack=int(m.group(1)),
                             spill_stores=int(m.group(2)),
                             spill_loads=int(m.group(3)))
        elif name and (m := re.search(r"Used (\d+) registers", line)):
            out[name]["registers"] = int(m.group(1))
    return out


def sass_hmma_counts(so) -> dict:
    """HMMA instructions per function of the library's SASS."""
    from torch.utils.cpp_extension import CUDA_HOME
    sass = subprocess.run(
        [os.path.join(CUDA_HOME, "bin", "cuobjdump"), "-sass", str(so)],
        capture_output=True, text=True, check=True, timeout=300).stdout
    counts = {}
    for part in sass.split("Function : ")[1:]:
        name = part.split(None, 1)[0]
        counts[name] = len(re.findall(r"\bHMMA\b", part))
    return counts


def phase_build():
    from xgan_torch.kernels import build
    from xgan_torch.kernels.convt import MMA_BLOCK_NS
    t0 = time.perf_counter()
    so = build.build(verbose=True)
    build.load_ops()
    print(f"build: {so.name} ready in {time.perf_counter() - t0:.1f} s")
    report = {k: v for k, v in ptxas_report(build.build_log()).items()
              if MMA_KERNEL in k}
    for name, r in sorted(report.items()):
        print(f"ptxas {name}: {r}")
    check(len(report) == len(MMA_BLOCK_NS),
          f"expected {len(MMA_BLOCK_NS)} {MMA_KERNEL} instantiations in the "
          f"ptxas log, got {sorted(report)}")
    check(all(r.get("spill_stores") == 0 and r.get("spill_loads") == 0
              for r in report.values()), f"{MMA_KERNEL} spills: {report}")
    hmma = {k: v for k, v in sass_hmma_counts(so).items() if MMA_KERNEL in k}
    print(f"SASS HMMA instructions per {MMA_KERNEL} instantiation: {hmma}")
    check(len(hmma) == len(MMA_BLOCK_NS) and all(hmma.values()),
          f"{MMA_KERNEL} SASS without HMMA: {hmma}")


def phase_kernels():
    """Each ConvT route vs the plain version; returns the kernel table entry
    (without ``launches``) for the bf16 main-path shapes."""
    import torch.nn.functional as F
    from xgan_torch import kernels
    from xgan_torch.kernels.build import load_ops
    from xgan_torch.kernels.convt import (ACTS, convt4x4s2_fused_cuda,
                                          convt4x4s2_fused_ref,
                                          pack_convt_weight, uses_mma)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(1)
    # (B, H, W, Cin, Cout, act, dtype, on the main path)
    cases = [(B, h, h, cin, cout, act, dt, dt == torch.bfloat16)
             for (h, cin, cout, act) in layer_shapes()
             for dt in (torch.float32, torch.bfloat16)]
    cases += [(B, 28, 28, 128, 64, "leaky_relu", torch.float32, False),
              (B, 28, 28, 128, 64, "leaky_relu", torch.bfloat16, False),
              (3, 5, 5, 32, 32, "relu", torch.bfloat16, False),  # ragged M
              (B, 6, 10, 64, 64, "relu", torch.bfloat16, False),  # H != W
              (B, 9, 9, 64, 40, "relu", torch.bfloat16, False)]  # Cout 40
    total = {"ms": 0.0, "core_ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0,
             "ops_ms": 0.0, "bytes_ms": 0.0, "bound_ms": 0.0,
             "max_abs_err": 0.0}
    for b, h, w, cin, cout, act, dt, main_path in cases:
        x = torch.randn(b, h, w, cin, generator=g, device=dev).to(dt)
        wt = torch.randn(cin, cout, 4, 4, generator=g, device=dev) \
            / math.sqrt(4 * cin)
        scale = torch.rand(cout, generator=g, device=dev) + 0.5
        shift = 0.1 * torch.randn(cout, generator=g, device=dev)
        wp = pack_convt_weight(wt, dt)
        mma = uses_mma(dt, cin)
        check(mma == (dt == torch.bfloat16), (cin, dt))
        before = kernels.LAUNCHES["convt4x4s2_mma"]
        got = convt4x4s2_fused_cuda(x, wp, scale, shift, act)
        check(kernels.LAUNCHES["convt4x4s2_mma"] - before == int(mma),
              "the route is not the one uses_mma names")
        ref = convt4x4s2_fused_ref(x, wp, scale, shift, act)
        torch.cuda.synchronize()
        check(got.shape == (b, 2 * h, 2 * w, cout) and got.dtype == dt,
              (got.shape, got.dtype))
        err = (got.float() - ref.float()).abs().max().item()
        tol = TOL[dt] * (1 + ref.float().abs().max().item())
        route = "tensor-core" if mma else "CUDA-core"
        name = (f"{b}x{h}x{w}x{cin}->{2 * h}x{2 * w}x{cout} {act} {dt} "
                f"({route})")
        check(err <= tol, f"{name}: max |kernel - plain| {err} > {tol}")
        if not main_path:
            print(f"check {name}: max_abs_err {err:.3g} (tol {tol:.3g})")
            continue
        wl = wt.to(dt)
        sc4, sh4 = scale.view(1, -1, 1, 1), shift.view(1, -1, 1, 1)
        x_nchw = x.permute(0, 3, 1, 2)  # channels_last view, no copy

        def library():
            y = F.conv_transpose2d(x_nchw, wl, stride=2, padding=1)
            y = y.float() * sc4 + sh4
            return (torch.relu(y) if act == "relu" else y).to(dt)

        ops = load_ops()
        ms = time_ms(lambda: convt4x4s2_fused_cuda(x, wp, scale, shift, act))
        # the CUDA-core kernel on the same bf16 inputs: the earlier design
        core_ms = time_ms(lambda: ops.convt4x4s2_fused(x, wp, scale, shift,
                                                       ACTS[act]))
        plain_ms = time_ms(
            lambda: convt4x4s2_fused_ref(x, wp, scale, shift, act), reps=5)
        library_ms = time_ms(library)
        flops = 2 * b * (2 * h) * (2 * w) * cout * 4 * cin
        nbytes = (x.numel() + wp.numel() + got.numel()) * x.element_size() \
            + 2 * 4 * cout
        ops_ms = flops / BF16_PEAK_FLOPS * 1e3
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        bound_ms = max(ops_ms, bytes_ms)
        print(f"layer {name}: max_abs_err {err:.3g} (tol {tol:.3g}); "
              f"kernel {ms:.4f} ms ({flops / ms / 1e9:.1f} TFLOP/s), "
              f"CUDA-core kernel {core_ms:.4f} ms, plain {plain_ms:.4f} ms, "
              f"conv_transpose2d+affine+act {library_ms:.4f} ms, kernel / "
              f"yardstick {ms / library_ms:.3f}; {flops / 1e9:.3f} GFLOP, "
              f"{nbytes / 1e6:.3f} MB, bound {bound_ms:.4f} ms "
              f"({'operations' if ops_ms >= bytes_ms else 'bytes'})")
        for k, v in (("ms", ms), ("core_ms", core_ms),
                     ("plain_ms", plain_ms), ("library_ms", library_ms),
                     ("ops_ms", ops_ms), ("bytes_ms", bytes_ms),
                     ("bound_ms", bound_ms)):
            total[k] += v
        total["max_abs_err"] = max(total["max_abs_err"], err)
    print(f"5 bf16 layers: kernel {total['ms']:.4f} ms, CUDA-core kernel "
          f"{total['core_ms']:.4f} ms, conv_transpose2d+affine+act "
          f"{total['library_ms']:.4f} ms, kernel / yardstick "
          f"{total['ms'] / total['library_ms']:.3f}, bound "
          f"{total['bound_ms']:.4f} ms")
    return {
        "name": "convt4x4s2_fused", "route": "cuda",
        "source": "xgan_torch/kernels/csrc/convt4x4s2_mma.cu,"
                  "xgan_torch/kernels/csrc/convt4x4s2.cu",
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
    check(launches.get("convt4x4s2_mma", 0) == want,
          f"{launches}: expected all {want} launches on the tensor-core route")
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


def _bytes_ms(nbytes: int) -> float:
    return nbytes / HBM_BYTES_PER_S * 1e3


def device_us(fn, calls: int = 20) -> float:
    """Device time per call of ``fn`` in µs, summed over the kernels the
    profiler records (the host's launch time left out)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    return sum(e.device_time for e in prof.events()
               if e.device_type == DeviceType.CUDA) / calls


def phase_gather():
    """mixed_gather vs its plain version, bitwise, on u8 stores at 224 px;
    returns the kernel table entry (without ``launches``) at B = 32."""
    from xgan_torch.kernels.gather import (mixed_gather_cuda,
                                           mixed_gather_ref, new_error_flag,
                                           raise_if_flagged)
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(2)
    real = torch.randint(0, 256, (4096, SIZE, SIZE, 3), generator=g,
                         device=dev, dtype=torch.uint8)
    synth = torch.randint(0, 256, (1024, SIZE, SIZE, 3), generator=g,
                          device=dev, dtype=torch.uint8)
    entry = None
    for b in (CLS_B, 256):
        # 32 index sets, used in turn by every timed call: 32 batches of
        # rows (>= 154 MB at B = 32) do not fit the 50 MB L2, so each call
        # reads its rows from HBM, as a train step does
        sets = [(torch.randint(0, 4096, (b,), generator=g, device=dev),
                 torch.randint(0, 1024, (b,), generator=g, device=dev),
                 torch.rand(b, generator=g, device=dev) < 0.5)
                for _ in range(32)]
        ridx, sidx, mixed = sets[0]
        for name, mask in (("mixed", mixed),
                           ("all real", torch.zeros_like(mixed)),
                           ("all synthetic", torch.ones_like(mixed))):
            got = mixed_gather_cuda(real, synth, ridx, sidx, mask)
            want = mixed_gather_ref(real, synth, ridx, sidx, mask)
            check(torch.equal(got, want), f"gather B={b} {name} differs")

        def in_turn(fn):
            it = itertools.cycle(sets)
            return lambda: fn(*next(it))

        err = new_error_flag(dev)
        kernel = in_turn(lambda r, s, m: mixed_gather_cuda(real, synth, r, s,
                                                           m, err))
        library = in_turn(lambda r, s, m: torch.where(
            m[:, None, None, None], synth[s], real[r]))
        ms = time_ms(kernel, reps=64)
        raise_if_flagged(err)
        plain_ms = time_ms(in_turn(lambda r, s, m: mixed_gather_ref(
            real, synth, r, s, m)), reps=64)
        library_ms = time_ms(library, reps=64)
        kernel_us = device_us(kernel, calls=64)
        library_us = device_us(library, calls=64)
        row = SIZE * SIZE * 3
        nbytes = 2 * b * row + 2 * b * 8 + b  # rows in and out, idx, mask
        bound_ms = _bytes_ms(nbytes)
        print(f"gather B={b}: bitwise equal (mixed, all real, all "
              f"synthetic); kernel {ms:.4f} ms "
              f"({nbytes / ms / 1e6:.1f} GB/s), plain {plain_ms:.4f} ms, "
              f"torch.where {library_ms:.4f} ms; {nbytes / 1e6:.3f} MB, "
              f"bound {bound_ms:.4f} ms (bytes); device time per call "
              f"(profiler): kernel {kernel_us:.2f} us "
              f"({nbytes / kernel_us / 1e3:.1f} GB/s), torch.where "
              f"{library_us:.2f} us")
        if entry is None:
            entry = {"name": "mixed_gather", "route": "cuda",
                     "source": "xgan_torch/kernels/csrc/mixed_gather.cu",
                     "replaces": "xgan/ops/pallas/gather.py:109",
                     "launches": 0, "max_abs_err": 0.0, "ms": ms,
                     "plain_ms": plain_ms, "bound_ms": bound_ms,
                     "bound_by": "bytes", "library_ms": library_ms}
    bad = ridx.clone()
    bad[3] = 4096
    try:
        mixed_gather_cuda(real, synth, bad, sidx, mixed)
    except IndexError as e:
        print(f"gather bad index: IndexError ({e})")
    else:
        raise AssertionError("an out-of-range index did not raise")
    return entry


def write_rsna_tree(root: str):
    """512 train and 128 test PNGs at 256 px with both labels, written by
    the port's encoder, and the two metadata CSVs."""
    from xgan_torch.native.png import encode_png_batch
    rng = np.random.default_rng(3)
    yy, xx = np.mgrid[0:RAW_SIZE, 0:RAW_SIZE]
    for sub, n, prefix in (("Training/Images", N_TRAIN, "train"),
                           ("Test", N_TEST, "test")):
        os.makedirs(os.path.join(root, sub))
        freq = rng.uniform(4, 40, (n, 1, 1, 3))
        imgs = 127 + 60 * np.sin(xx[None, ..., None] / freq) \
            + rng.normal(0, 20, (n, RAW_SIZE, RAW_SIZE, 3))
        paths = [os.path.join(root, sub, f"{prefix}{i:04d}.png")
                 for i in range(n)]
        check(encode_png_batch(np.clip(imgs, 0, 255).astype(np.uint8),
                               paths) == 0, "PNG writes failed")
    classes = ["Lung Opacity", "Normal", "No Lung Opacity / Not Normal"]
    with open(os.path.join(root, "stage2_train_metadata.csv"), "w") as f:
        f.write("patientId,class\n" + "".join(
            f"train{i:04d},{classes[i % 3]}\n" for i in range(N_TRAIN)))
    with open(os.path.join(root, "stage2_test_metadata.csv"), "w") as f:
        f.write("patientId,PredictionString\n" + "".join(
            f"test{i:04d},{'0.5 0 0 100 100' if i % 2 else '0.9 1 1 9 9'}\n"
            for i in range(N_TEST)))


def phase_stores(root: str, synth_dir: str):
    """Times the host store build (decode + resize 256 -> 224) of the
    train images; returns the host (train, synthetic) stores."""
    from xgan_torch.data import rsna
    from xgan_torch.data.store import ImageStore, decode_folder_store
    ids, labels = rsna.load_train_metadata(
        os.path.join(root, "stage2_train_metadata.csv"))
    t0 = time.perf_counter()
    train = ImageStore.build(rsna.train_paths(root, ids), labels, SIZE,
                             workers=8)
    dt = time.perf_counter() - t0
    print(f"store build: {len(ids)} PNGs {RAW_SIZE} px -> {SIZE} px in "
          f"{dt:.3f} s ({dt / len(ids) * 1e3:.3f} ms per image, 8 "
          "threads)")
    check(train.images.shape == (N_TRAIN, SIZE, SIZE, 3)
          and train.images.std() > 10, "train store is wrong")
    synth = decode_folder_store(synth_dir, SIZE, workers=8)
    check(len(synth) == NUM_IMAGES, len(synth))
    return train, synth


RUNS = {
    "A": ["--use-synthetic", "--use-curriculum", "--curriculum-schedule",
          "0:0.25,1:0.5", "--k-folds", "2", "--epochs", "2"],
    "B": ["--use-synthetic", "--k-folds", "1", "--epochs", "1",
          "--unfreeze"],
}
HISTORY_KEYS = {"epoch", "train_loss", "train_acc", "val_loss", "val_acc",
                "synthetic_ratio"}
METRIC_KEYS = {"loss", "accuracy", "weighted_precision", "weighted_recall",
               "weighted_f1_score", "auroc"}


def phase_classifier(tmp: str, root: str, synth_dir: str):
    """Runs A and B through the CLI; returns the mixed_gather launches of
    both runs."""
    from xgan_torch import kernels
    from xgan_torch.cli.train_classifier import main as classifier_main
    from xgan_torch.models.resnet import ResNet50
    total = 0
    for run, extra in RUNS.items():
        out = os.path.join(tmp, f"run{run}")
        argv = ["--data-dir", root, "--synthetic-dir", synth_dir,
                "--model-dir", os.path.join(out, "models"),
                "--results-dir", os.path.join(out, "metrics"),
                "--cache-dir", os.path.join(tmp, "cache"),
                "--image-size", str(SIZE), "--batch-size", str(CLS_B),
                "--compute-dtype", "bf16", "--workers", "8", *extra]
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        result = classifier_main(argv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(kernels.LAUNCHES)
        if run == "A":  # curriculum: k-fold train splits, real-length epochs
            strategy, folds, epochs = "curriculum", 2, 2
            steps = folds * epochs * math.ceil(N_TRAIN // 2 / CLS_B)
            check(set(result) == {"folds", "average", "std_dev"}, result)
            metrics = result["average"]
        else:  # augmented: all real + all synthetic images per epoch
            strategy, folds, epochs = "augmented", 1, 1
            steps = math.ceil((N_TRAIN + NUM_IMAGES) / CLS_B)
            metrics = result
        print(f"classifier run {run} ({strategy}): {wall:.1f} s wall, "
              f"launches {launches}, {steps} train steps; metrics "
              + ", ".join(f"{k} {v:.4f}" for k, v in metrics.items()))
        check(launches.get("mixed_gather", 0) == steps,
              f"run {run}: mixed_gather launched "
              f"{launches.get('mixed_gather', 0)} times for {steps} steps")
        check(set(metrics) == METRIC_KEYS
              and all(math.isfinite(v) for v in metrics.values()), metrics)
        total += steps
        mdir = os.path.join(out, "metrics")
        prefixes = ([f"fold_{i}_" for i in range(1, folds + 1)]
                    if run == "A" else [""])
        summary = (f"{strategy}_cv_summary.json" if run == "A"
                   else f"{strategy}_final_metrics.json")
        names = [f"{p}{strategy}_training_history.json" for p in prefixes]
        check(sorted(os.listdir(mdir)) == sorted(names + [summary]),
              os.listdir(mdir))
        for name in names:
            with open(os.path.join(mdir, name)) as f:
                hist = json.load(f)
            check(set(hist) == HISTORY_KEYS
                  and len(hist["epoch"]) == epochs
                  and all(math.isfinite(v) for v in hist["train_loss"]),
                  (name, hist))
        with open(os.path.join(mdir, summary)) as f:
            keys = set(json.load(f))
        check(keys == ({"folds", "average", "std_dev"} if run == "A"
                       else {"config", "metrics"}), keys)
        ckpts = os.listdir(os.path.join(out, "models"))
        check(bool(ckpts), "no checkpoint written")
        for name in ckpts:
            model = ResNet50(2)
            model.load_state_dict(torch.load(
                os.path.join(out, "models", name), weights_only=True),
                strict=True)
        print(f"run {run}: {sorted(os.listdir(mdir))} have the reference "
              f"keys; {sorted(ckpts)} load strictly")
    return total


def phase_f32_step(train, synth):
    """One f32 train step (TF32 off, deterministic cuDNN) from the same
    weights and draws, through the kernel and through the plain gather:
    the u8 batch and the loss must be equal."""
    from xgan_torch.data import mixer
    from xgan_torch.data.pipeline import DeviceStore
    from xgan_torch.kernels.gather import mixed_gather_ref
    from xgan_torch.models.resnet import ResNet50
    from xgan_torch.train.classifier import classifier_optimizer, train_step
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    dev = torch.device("cuda")
    real, syn = DeviceStore(train, dev), DeviceStore(synth, dev)
    g = torch.Generator(device=dev).manual_seed(4)
    idx = torch.randint(0, len(real), (CLS_B,), generator=g, device=dev)
    use_synth = torch.rand(CLS_B, generator=g, device=dev) < 0.5
    pick = torch.randint(0, len(syn), (CLS_B,), generator=g, device=dev)
    flip = torch.rand(CLS_B, generator=g, device=dev) < 0.5
    init = ResNet50(2, device=dev, generator=torch.Generator(
        device=dev).manual_seed(5)).state_dict()

    def plain(real_u8, synth_u8, ridx, sidx, mask, err=None):
        return mixed_gather_ref(real_u8, synth_u8, ridx, sidx, mask)

    batches, losses = [], []
    for gather in (None, plain):
        saved = mixer.mixed_gather
        if gather is not None:
            mixer.mixed_gather = gather
        try:
            batch, _ = mixer.mix_batch(real.images, real.labels, idx,
                                       syn.images, syn.labels, 0.5,
                                       use_synth=use_synth, synth_pick=pick)
            model = ResNet50(2, device=dev)
            model.load_state_dict(init)
            opt = classifier_optimizer(model, 1e-3, freeze_base=False)
            loss, _, _ = train_step(model, opt, real, syn, idx, mode="mix",
                                    ratio=0.5, flip=flip,
                                    use_synth=use_synth, synth_pick=pick)
        finally:
            mixer.mixed_gather = saved
        batches.append(batch)
        losses.append(loss)
    torch.backends.cudnn.deterministic = False
    check(torch.equal(*batches), "f32 step: u8 batches differ")
    check(torch.equal(*losses), "f32 step: losses differ")
    print(f"f32 train step, kernel vs plain gather: bitwise equal u8 batch "
          f"({int(use_synth.sum())} synthetic rows) and loss "
          f"{losses[0].mean().item():.6f}")


def phase_classifier_profile(train, synth):
    """Warm train steps in run A's (mix, frozen) and run B's (concat,
    unfrozen) configurations: ms per step, imgs/s, the top device ops,
    one mixed_gather per step, the device idle share."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from xgan_torch.data.pipeline import DeviceStore
    from xgan_torch.models.resnet import ResNet50
    from xgan_torch.train.classifier import classifier_optimizer, train_step
    dev = torch.device("cuda")
    real, syn = DeviceStore(train, dev), DeviceStore(synth, dev)
    g = torch.Generator(device=dev).manual_seed(6)
    out = {}
    for run, mode, freeze, hi in (("A", "mix", True, len(real)),
                                  ("B", "concat", False,
                                   len(real) + len(syn))):
        model = ResNet50(2, dtype=torch.bfloat16, device=dev,
                         generator=torch.Generator(dev).manual_seed(7))
        opt = classifier_optimizer(model, 1e-3, freeze_base=freeze)
        idx = torch.randint(0, hi, (40, CLS_B), generator=g, device=dev)

        def step(i):
            return train_step(model, opt, real, syn, idx[i], mode=mode,
                              dtype=torch.bfloat16, ratio=0.5, generator=g)

        for i in range(5):
            step(i)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(5, 35):
            step(i)
        torch.cuda.synchronize()
        step_ms = (time.perf_counter() - t0) / 30 * 1e3
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            step(35)
            torch.cuda.synchronize()
        kernels = [e for e in prof.events()
                   if e.device_type == DeviceType.CUDA]
        ours = [e for e in kernels if "mixed_gather" in e.name]
        busy_ms = sum(e.device_time for e in kernels) / 1e3
        gather_us = sum(e.device_time for e in ours)
        print(f"classifier step, run {run} config ({mode}, "
              f"{'frozen' if freeze else 'unfrozen'} base, bf16, "
              f"B={CLS_B}): {step_ms:.3f} ms per step (mean of 30 warm), "
              f"{CLS_B / step_ms * 1e3:.1f} imgs/s; profiled step: "
              f"{len(kernels)} kernels, {busy_ms:.3f} ms device time, "
              f"{len(ours)} mixed_gather ({gather_us:.1f} us); device idle "
              f"share ~{1 - busy_ms / step_ms:.3f}")
        top = sorted(prof.key_averages(),
                     key=lambda e: -e.self_device_time_total)
        for e in top[:8]:
            if e.self_device_time_total > 0:
                print(f"  {e.self_device_time_total / 1e3:9.3f} ms  "
                      f"x{e.count:<3d} {e.key[:90]}")
        check(len(ours) == 1, [e.name for e in ours])
        out[run] = step_ms
    return out


def main():
    smi = phase_card()
    phase_build()
    entry = phase_kernels()
    gather_entry = phase_gather()
    with tempfile.TemporaryDirectory(prefix="xgan_chip_smoke_") as tmp:
        launches, warm_rate = phase_sampler(tmp)
        root, synth_dir = os.path.join(tmp, "rsna"), \
            os.path.join(tmp, "synthetic")
        write_rsna_tree(root)
        train, synth = phase_stores(root, synth_dir)
        gather_entry["launches"] = phase_classifier(tmp, root, synth_dir)
    phase_f32_step(train, synth)
    phase_classifier_profile(train, synth)
    busy_ms = phase_profile()
    loop_ms_per_batch = B / warm_rate * 1e3
    print(f"sampler loop: {loop_ms_per_batch:.2f} ms per batch of {B} "
          f"(warm median) vs {busy_ms:.3f} ms profiled device time per "
          f"batch: device idle share ~{1 - busy_ms / loop_ms_per_batch:.3f}")
    entry["launches"] = launches["convt4x4s2_fused"]
    print(json.dumps({"kernels": [entry, gather_entry]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
