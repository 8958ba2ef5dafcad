#!/usr/bin/env python3
"""On-card check of the PyTorch/CUDA port (``xgan_torch``) on one H100.

    python3 chip_smoke.py

Phases, each of which raises on failure (the script then exits non-zero):

1. the card: ``nvidia-smi`` name and power limit; compute capability 9.0;
2. builds the CUDA kernels from ``xgan_torch/kernels/csrc``; prints what
   ``ptxas -v`` says of each instantiation of the tensor-core ConvT
   kernels (the warpgroup designs ``convt4x4s2_wgmma`` and
   ``convt4x4s2_band``, and the ``mma.sync`` kernel ``convt4x4s2_mma``)
   and checks that none spills or has its wgmma products serialised, that
   the warpgroup kernels' SASS (``cuobjdump -sass``) holds ``HGMMA`` and
   the ``mma.sync`` kernel's ``HMMA`` tensor-core instructions;
3. holds each ConvT route against its plain PyTorch version on the card at
   the shapes the sampler gives it (DCGAN G-224, fg 64, batch 64): f32
   with TF32 off on the CUDA-core kernel, bf16 on the design the tile table
   names (``convt_route``: wgmma or band), plus bf16 cases the ladder
   lacks (ragged M, H != W, Cout 8, 40 and 3 at a wide Cin, leaky ReLU,
   the ladder at B = 1 and B = 128); times per bf16 layer the design, the
   ``mma.sync`` kernel and the CUDA-core kernel on the same bf16 inputs,
   the plain version and a PyTorch library yardstick with CUDA events,
   against the bound;
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
   the JSON files, the checkpoints and the figures (run A's three curves
   and two CV bar charts, run B's three curves; each decodes), that
   ``mixed_gather`` launched once per train step and never in validation
   or test, and that one f32 train step through the kernel and through
   the plain gather gives the same u8 batch and the same loss;
8. trains the DCGAN through its CLI (``xgan_torch.cli.train_gan``) at
   full width (224 px, fg = fd = 64, latent 100, B = 128, bf16) on the
   same tree, 2 epochs of 4 steps: checks the history JSON, the sample
   sheets, ``gan_loss_curve.png`` and the final ``.pth`` files, and that
   every k4s2 layer of the train steps and the sheets ran on the
   tensor-core ConvT kernel (5 launches each); then samples from its
   ``generator_final.pth`` through the sampler CLI;
9. gathers runs A and B into one metrics and one model directory and runs
   the analyzer through its CLI (``xgan_torch.cli.analyze_results``) on
   the card at full width: the report, the comparison plots, SSIM of 500
   of the sampler's PNGs against 100 of the tree's positives at 224 px,
   Grad-CAM of both ResNet-50 checkpoints for 3 positive, 3 negative and
   3 synthetic samples. Every output must decode and the report must
   equal the one ``--cpu`` writes from the same metrics; SSIM on the card
   must be within 1e-5 of the CPU for 20 x 10 of those images, and one
   conv3 CAM within 5e-3 of the CPU's. Prints the all-pairs SSIM time by
   CUDA events, the time per CAM and the CLI's wall time;
10. times and profiles warm train steps of both classifier runs'
    configurations: ms per step, imgs/s, the top device ops, one
    ``mixed_gather`` kernel per step, the device idle share;
11. holds one f32 GAN train step at full width (B = 16) through the
    kernel against the same step through the plain version (metrics, G's
    gradient norms), and the ConvT's training form (kernel forward, cuDNN
    backward) against ``F.conv_transpose2d`` under autograd at the five
    bf16 layers at B = 128;
12. times 20 warm bf16 GAN train steps at B = 128 and profiles one (top
    device ops, the ConvT kernels' share, the idle share); times the five
    ConvT forwards at the training shapes against their bound, the plain
    version and cuDNN;
13. WGAN-GP: right after phase 3, the five k4s2 layers of its generator
    (the DCGAN ladder one width up: 1024 -> 512 at 7x7 ... 64 -> 3 at
    112x112) at B = 64 on the tile table's design against the plain
    version, with the sampler's epilogue and the train forward's, each
    timed against its bound, the ``mma.sync`` kernel on the same inputs,
    the plain version and cuDNN; after the
    analyzer, its sampler CLI (``xgan_torch.cli.generate_synthetic_wgan``:
    512 PNGs at full width, 5 launches a batch, an f32 batch of the kernel
    path within 1 u8 level of the plain path) and its trainer CLI
    (``xgan_torch.cli.train_wggan``: 224 px, fg = fd = 64, B = 64, 5
    critic updates, bf16, 4 steps: the history, sheets, loss figure and
    ``.pth`` files, 30 launches a step and 5 a sheet), then the sampler on
    its ``generator_final.pth``; after phase 12, one f32 WGAN-GP step (B =
    16, 2 critic updates) through the kernel against the plain version
    (losses, G's and the critic's gradient norms), and 8 warm bf16 steps
    at B = 64 with one profiled (ms per step, imgs/s, top device ops, the
    ConvT kernels' share, the idle share, the model FLOPs and their
    bound);
14. CGAN, which runs no hand-written kernel (every launch count must stay
    0): after the WGAN-GP CLIs, its trainer CLI (``xgan_torch.cli
    .train_cgan``: 224 px, fg = fd = 32, latent 100, B = 32, bf16, random
    VGG16 features, 4 steps: the history's nine keys, the sheets, the loss
    figure and the ``.pth`` files) and its sampler CLI on that
    ``generator_final.pth`` (64 PNGs); after the WGAN-GP profile, one f32
    CGAN step (B = 16, after 3 warm-up steps) on the card against the CPU
    (metrics, G's and D's gradient norms; the same step with TF32 on must
    fail those limits), and 20 warm bf16 steps at B = 32 with one profiled
    (ms per step, imgs/s, top device ops, the idle share, the model FLOPs
    and their bound) at epoch 0 and, the gate a select on the device (the
    trainer's capturable Adam), at epoch 5 with the gate held open and
    held closed;
15. the GAN loop features through the CLIs, after the CGAN CLIs: resume
    (the DCGAN CLI in f32 with TF32 off and deterministic cuDNN, EMA on,
    2 epochs of 2 steps against 1 epoch and then ``--resume-from auto``:
    history and final G, D and EMA within 1e-6 relative), the time the
    loop blocks at an epoch boundary with async saves against the bytes
    written, preemption (the DCGAN CLI in a subprocess gets SIGTERM after
    its first epoch: exit 0, the notice, ``snapshot_last.pth``; ``--resume-
    from auto`` completes the epochs), the EMA generator through the
    sampler CLI (5 launches a batch), ``--trace-dir`` (one trace that
    names the ConvT kernel) and the WGAN-GP and CGAN CLIs with
    ``--ema-decay 0.999 --resume-from auto`` over 1 + 1 epochs;
16. ``--grad-accum``, after the CGAN profile: the bf16 step at B = 128 as
    A = 1 and A = 4 (ms, imgs/s, ConvT launches 5 and 40, peak memory),
    and one f32 A = 2 step (B = 16) through the kernel against the plain
    version at the GAN step check's limits;
17. ``--steps-per-call``: 8 f32 steps (B = 16, EMA on) as K = 1 eager
    steps against K = 4 (a graph replay) within rtol 2e-4, atol 2e-5, then
    bf16 at B = 128: ms per step and the device idle share of K = 1 and
    K = 4, the dispatcher's 5 ConvT launches a replayed step held against
    a profiler trace of one replay, which must show the tensor-core
    kernel;
18. the classifier's loop flags through its CLI at full width, right
    after phase 15 on the same tree: ``--grad-accum 4`` against A = 1
    (one ``mixed_gather`` launch a train step, the run's time and peak
    memory), ``--remat`` in each scope against none (ms per step and peak
    memory; one f32 step each within 1e-6 of no remat, BN statistics
    included), preemption (SIGTERM to a 2-fold f32 run in fold 1's last
    epoch: exit 0, the notice, no summary; ``--resume-from auto`` loads
    fold 1, trains fold 2, and its summary is within 1e-6 of a straight
    run's) and ``--trace-dir`` (one trace naming ``mixed_gather``);
19. WGAN-GP's loop flags, after phase 17: one f32 A = 2 step through the
    kernel against the plain version (phase 16's limits and TF32
    control), 8 f32 steps as K = 4 replays against K = 1 (LOOP_TOL), and
    bf16 at B = 64 with 5 critic updates: ms per step, idle share and
    peak memory for K = 1, K = 4 and A = 4, ConvT launches of 5 (5 + 1) A
    a step and 5 (5 + 1) K a replay, held against the dispatcher's count
    and a profiler trace of one replay that shows the tensor-core kernel;
20. CGAN's loop flags: 12 f32 steps as K = 4 replays against K = 1, the
    replay after the capture at epoch 5 (the epoch a device input); a
    replay at epoch 5 with the gate held closed (D and its Adam state
    bitwise unchanged, its BN buffers moved) and one held open; one f32
    A = 2 step on the card against the CPU (phase 14's limits and TF32
    control); bf16 K = 1 and K = 4 ms per step at B = 32; no kernel
    launch;
21. PNGs of every kind, right after the store build of phase 7 (which,
    like the classifier CLI's stores, must decode through the compiled
    row unfilter only): the compiled ``png_unfilter`` op bitwise against
    its plain version on every filter type at every bytes-per-pixel 1-8
    and on the rows of 1024-px Paeth and Average grey PNGs written here
    with numpy and zlib; the store's decode of those and of 16-bit grey
    and RGB, 2-bit grey, 4-bit palette and interlaced PNGs through the
    op bitwise against the plain path (both 16-bit rules); ms per image
    of the decode and of the store build on 1 and on 8 threads (8
    decodes on 8 threads must take under 4 times one on 1);
22. ``--parallel-folds``, last (after the sampler profile of phase 5,
    so that every earlier phase runs as before it): the fold-batched
    ``mixed_gather`` (k = 5, (5, 32) indices, one launch) bitwise
    against its plain version and 5 single launches, timed beside them;
    one f32 lockstep step against the 5 sequential fold steps on the
    card (losses, every gradient norm within 1e-3 plus twice a measured
    floor; the same step with TF32 on must fail); a fold with an
    all-zero mask bitwise frozen, its Adam step count included; the CLI
    with run A's configuration and ``--parallel-folds`` (one launch a
    lockstep step, run A's file names and JSON keys); bf16 lockstep
    steps at k = 5, frozen and ``--unfreeze``, timed beside 5 sequential
    steps with the idle share and the peak memory, and the fold-batched
    gather's device time;
23. the inference surface, last: a G-224 (fg 64, latent 100) and a
    ResNet-50 with seeded random weights written by the port's flax
    msgpack writer and as ``.pth`` twins, sampled (128 PNGs, 5 ConvT
    launches a batch) and predicted (the tree's test PNGs) bitwise alike
    from both; ``export_model`` of both in bf16 and int8 (verified
    against the live model) and f32 (sizes: int8 at most 0.35 of f32),
    the G artifact's rows at batch 1, 2 and 4 against 8, its call time
    in bf16 and int8, its 5 ConvT kernels counted by the profiler in a
    fresh process, and a CPU-exported artifact refused; predict over the
    tree's 512 train PNGs from the ``.pth`` and the bf16 ``.pt2``
    (imgs/s, the host decode's share); the server
    (``xgan_torch.cli.serve``, a process of its own on port 0) on the
    bf16 and int8 G artifacts and the bf16 classifier artifact: 64
    requests at concurrency 1 and 8 each (p50, p99, requests/s, the
    dispatch occupancy), every batched ``/generate`` bitwise the
    unbatched one, the SIGTERM drain; and ``data_loader`` in its five
    modes (one ``mixed_gather`` launch a mixed batch, 3 in
    ``phased_kfold``);
24. data parallelism across ranks (A14, part 1), last: (a) the DCGAN
    CLI (224 px, B = 128, 2 epochs of 2 steps) and the classifier CLI
    (augmented, ResNet-50, B = 32, 2 steps) each in a process of its own
    under a ``torchrun`` environment of one rank on NCCL with
    ``--shard-store``, against the same CLI with no group (f32, TF32 off,
    deterministic cuDNN): the DCGAN's first step within 1e-4 * (1 +
    |ref|) and every step within 5e-2, the classifier's history and
    metrics within 1e-4 * (1 + |ref|), the same files and launches; then
    a world-1 NCCL rank (``--phase dist1``) holds an f32 DCGAN step (B =
    128) and classifier step (mix, B = 32) against no group and times
    bf16 steps with the group against none (the DP path's cost on one
    card); (b) two ranks sharing the card over gloo's CUDA all-reduce
    (``--phase dist/0``, ``dist/1``; NCCL refuses two ranks on one
    device) hold the same steps against one rank, ``--shard-store``'s
    take and step bitwise against the replicated ones, each rank's
    gathered rows bitwise against the plain version, count the
    all-reduces a step, time bf16 steps (two ranks on one card, not a
    scaling figure), and must end with bitwise equal parameters;
25. A14 part 3, after 24 (``phase_a14_3``; ``python3 chip_smoke.py --only
    a14_3`` runs it alone after the build, the sampler and the stores):
    the classifier CLI with ``--parallel-folds`` at k = 2 and 3 (f32, B =
    16; k = 3 with ``--grad-accum 2``) under a world-1 NCCL launch and as
    two gloo ranks on the card (``--dist-backend gloo``) against no
    group, every JSON number within 1e-4 * (1 + |ref|) and the same
    files; the DCGAN CLI at ``--steps-per-call 4`` under NCCL with
    ``--shard-opt-state`` against no group; a gloo launch at K = 2, which
    must exit 1 naming NCCL; meanwhile ZeRO-1 on two gloo ranks
    (``--phase zero/RANK``: DCGAN-224 and unfrozen ResNet-50 parameters
    after 3 f32 steps bitwise those of replicated Adam, the optimizers'
    state bytes and the steps' peak memory per rank, a rank's
    fold-batched ``mixed_gather``); then, in two processes (``--phase
    kstep_dcgan``, ``kstep_wgan``, world-1 NCCL) started as the ZeRO-1
    ranks end, the DCGAN-224 (B = 128), CGAN-224 (B = 32) and
    WGAN-GP-224 (B = 64) steps at K = 4 against K = 1 on the DP path
    (f32), the DCGAN's K = 4 run with a ``ShardedAdam`` on the group
    bitwise plain Adam's (its NCCL all-gather captured), beside the
    phase's other processes; then, each alone on the card, the replay's
    ConvT kernels against a profiler trace of one replay, and bf16 ms per
    step of the DP path at K = 1 and K = 4;
26. A14 parts 4 and 5, after 25 (``phase_a14_4``; ``python3
    chip_smoke.py --only a14_4`` or ``--only a14_5`` runs one part alone
    after the build, the sampler and the stores): tensor parallelism,
    ``--model-parallel 2`` over two gloo ranks sharing the card (data 1 x
    model 2; a pair of ranks a part, ``--phase tp4/RANK`` and
    ``tp5/RANK``), f32 with TF32 off and deterministic cuDNN, against one
    rank (a process a part, ``--phase tp4ref``, ``tp5ref``), 3 steps
    each: part 4's DCGAN-224 step (B = 128) and unfrozen ResNet-50 step
    (mix, B = 32), part 5's WGAN-GP-224 step (5 critic updates, B = 32:
    the budget's cut of the trainer's 64) and CGAN-224 step (B = 32,
    random VGG16, the gate open), the GANs' after 3 shared bf16 warm-up
    steps: the first step's metrics within 1e-4 * (1 + |ref|), its
    gradient norms within 1e-3 plus twice the measured floor, a TF32
    control that must fail, the parameters after 3 steps within the step
    envelope; the replicated leaves bitwise equal on both ranks, the
    slices not; G's sliced ConvTs launched on each rank, and held against
    their plain version in bf16 and f32 and timed alone against their
    bound and cuDNN at the trainers' batch: (128, 7, 7, 512) -> 128
    (DCGAN), (64, 7, 7, 1024) -> 256 and (64, 14, 14, 512) -> 128
    (WGAN-GP); the parameter and Adam bytes per rank over one rank's
    (``TP_RATIOS``: 0.5651 DCGAN G, 0.5339 D, 0.5208 ResNet-50, 0.5204
    WGAN-GP G, 0.5287 critic, 0.9961 CGAN G, 0.6434 CGAN D); bf16 ms per
    CGAN step of the TP ranks and of one rank (the WGAN-GP's TP step over
    gloo is not timed: it measures host staging alone); before the
    WGAN-GP's TP steps rank 0 alone runs a one-rank step, and the holds
    pass all the same. Then
    the four trainers' CLIs under the 2-rank gloo launch at
    ``--model-parallel 2`` against no group (the same files and
    launches, a GAN history's step 1 within 1e-4 * (1 + |ref|), the
    classifier's JSON within 1e-4 * (1 + |ref|)); part 4's run beside
    phase 24's CLIs, part 5's beside phase 25's;
27. prints the kernel table line, the card line and, last, the result
    line.

Profiler windows on the card have lost kernel records (ROADMAP.md C6):
the profiler drops a kernel whose time, mapped from the card's clock,
falls outside the window, and that mapping can be off by milliseconds.
So a window that holds a kernel count (5's profile, 12, 17, 19, 23's
artifact call and 25's replays) keeps half a second of idle host time on each side of
its work and prints how far its first and last kernels lie from its
edges; each such phase also runs in a new process of this script
(``--phase NAME TMP CARD``, on the train store saved under the temporary
directory), and the ``--trace-dir`` runs of 15 and 18 run their CLI in a
process of its own. Every phase prints its seconds as it ends.

Without a CUDA device, or run away from the repo, it exits non-zero and
prints no result.
"""
from __future__ import annotations

import atexit
import collections
import contextlib
import functools
import itertools
import json
import math
import os
import re
import statistics
import subprocess
import sys
import tempfile
import threading
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


START = time.perf_counter()


def timed(fn):
    """``fn``, printing its seconds and the script's seconds so far."""
    @functools.wraps(fn)
    def run(*args, **kwargs):
        t0 = time.perf_counter()
        try:
            return fn(*args, **kwargs)
        finally:
            now = time.perf_counter()
            print(f"[{now - START:.1f} s] {fn.__name__}: {now - t0:.1f} s",
                  flush=True)
    return run


def check(ok: bool, what) -> None:
    """Fail the run (unlike ``assert``, this also holds under ``-O``)."""
    if not ok:
        raise AssertionError(what)


@contextlib.contextmanager
def unfilter_routes():
    """Counts, while open, the PNG row unfilter's calls by route
    (``"compiled"``, ``"plain"``): ``xgan_torch.native.png.unfilter``
    wrapped, also for the threads that decode."""
    from xgan_torch.native import png
    calls, lock, inner = collections.Counter(), threading.Lock(), png.unfilter

    def counted(*args, compiled=False, **kw):
        with lock:
            calls["compiled" if compiled else "plain"] += 1
        return inner(*args, compiled=compiled, **kw)
    png.unfilter = counted
    try:
        yield calls
    finally:
        png.unfilter = inner


# the WGAN-GP generator's ladder: the DCGAN one (fg*8 ... fg//2) one width up
WGAN_WIDTHS = [FG * 16, FG * 8, FG * 4, FG * 2, FG]


def layer_shapes(widths=None):
    """(H, Cin, Cout, act) of the five k4s2 layers of a G-224 ladder: the
    DCGAN one unless ``widths`` names the first five output widths."""
    widths = list(widths or [FG * 8, FG * 4, FG * 2, FG, FG // 2]) + [3]
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
WGMMA_KERNEL = "convt4x4s2_wgmma_kernel"
BAND_KERNEL = "convt4x4s2_band_kernel"
# the warpgroup designs' counters: the tile table routes every bf16 layer
# of both G-224 ladders to one of them
NEW_DESIGNS = ("convt4x4s2_wgmma", "convt4x4s2_band")


def on_new_designs(launches, want: int) -> bool:
    """``want`` ConvT launches, each counted as a tensor-core launch and
    as a launch of a warpgroup design (wgmma or band)."""
    return (launches.get("convt4x4s2_mma", 0) == want
            and sum(launches.get(k, 0) for k in NEW_DESIGNS) == want)


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


def sass_counts(so, opcodes=("HMMA", "HGMMA")) -> dict:
    """Instructions of each opcode per function of the library's SASS."""
    from torch.utils.cpp_extension import CUDA_HOME
    sass = subprocess.run(
        [os.path.join(CUDA_HOME, "bin", "cuobjdump"), "-sass", str(so)],
        capture_output=True, text=True, check=True, timeout=300).stdout
    counts = {}
    for part in sass.split("Function : ")[1:]:
        name = part.split(None, 1)[0]
        counts[name] = {op: len(re.findall(rf"\b{op}\b", part))
                        for op in opcodes}
    return counts


def phase_build():
    from xgan_torch.kernels import build
    from xgan_torch.kernels.convt import (BAND_CINS, MMA_BLOCK_NS,
                                          WGMMA_BLOCK_NS, band_np,
                                          convt_route)
    t0 = time.perf_counter()
    so = build.build(verbose=True)
    build.load_ops()
    print(f"build: {so.name} ready in {time.perf_counter() - t0:.1f} s")
    log = build.build_log()
    ptxas = ptxas_report(log)
    sass = sass_counts(so)
    # (kernel, instantiations, the SASS opcode of its products)
    for kernel, n, op in ((MMA_KERNEL, len(MMA_BLOCK_NS), "HMMA"),
                          (WGMMA_KERNEL, len(WGMMA_BLOCK_NS), "HGMMA"),
                          (BAND_KERNEL, 3 * len(BAND_CINS), "HGMMA")):
        report = {k: v for k, v in ptxas.items() if kernel in k}
        for name, r in sorted(report.items()):
            print(f"ptxas {name}: {r}")
        check(len(report) == n, f"expected {n} {kernel} instantiations in "
              f"the ptxas log, got {sorted(report)}")
        check(all(r.get("spill_stores") == 0 and r.get("spill_loads") == 0
                  for r in report.values()), f"{kernel} spills: {report}")
        ops = {k: v[op] for k, v in sass.items() if kernel in k}
        print(f"SASS {op} instructions per {kernel} instantiation: {ops}")
        check(len(ops) == n and all(ops.values()),
              f"{kernel} SASS without {op}: {ops}")
    # ptxas serialises a function's wgmma products when another
    # instruction may touch their registers in flight, or a product sits
    # on a path it must treat as divergent (warnings C7515, C7520)
    serial = [line for line in log.splitlines()
              if "instructions are serialized" in line
              and "convt4x4s2" in line]
    check(not serial, "wgmma products serialised:\n" + "\n".join(serial))
    # every layer of both ladders is routed to a warpgroup design, on a
    # tile of those built
    for h, cin, cout, _ in layer_shapes() + layer_shapes(WGAN_WIDTHS):
        route = convt_route(torch.bfloat16, h, h, cin, cout)
        check(route.design in ("wgmma", "band"),
              f"{(h, cin, cout)} is routed to {route}")
        kernel = WGMMA_KERNEL if route.design == "wgmma" else BAND_KERNEL
        tag = (f"ILi{route.block_n}E" if route.design == "wgmma"
               else f"ILi{cin}ELi{band_np(cout)}E")
        check(any(kernel in k and tag in k for k in ptxas),
              f"no {kernel} {tag} for {(h, cin, cout)} in the ptxas log")
    print("tiles of the DCGAN and WGAN-GP ladders: each instantiation "
          "built without spills or serialised products")


def phase_kernels():
    """Each ConvT route vs the plain version; returns the kernel table entry
    (without ``launches``) for the bf16 main-path shapes."""
    import torch.nn.functional as F
    from xgan_torch import kernels
    from xgan_torch.kernels.build import load_ops
    from xgan_torch.kernels.convt import (ACTS, convt4x4s2_fused_cuda,
                                          convt4x4s2_fused_ref, convt_route,
                                          mma_tiles, pack_convt_weight,
                                          uses_mma)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(1)
    # (B, H, W, Cin, Cout, act, dtype, on the main path)
    ladder = layer_shapes()
    cases = [(B, h, h, cin, cout, act, dt, dt == torch.bfloat16)
             for (h, cin, cout, act) in ladder
             for dt in (torch.float32, torch.bfloat16)]
    bf = torch.bfloat16
    cases += [(B, 28, 28, 128, 64, "leaky_relu", torch.float32, False),
              (B, 28, 28, 128, 64, "leaky_relu", bf, False),
              (3, 5, 5, 32, 64, "relu", bf, False),  # ragged M
              (B, 6, 10, 64, 64, "relu", bf, False),  # H != W
              (B, 9, 9, 64, 40, "relu", bf, False),  # Cout 40
              (B, 7, 7, 512, 8, "relu", bf, False),  # Cout 8, wide Cin
              (B, 7, 7, 512, 40, "leaky_relu", bf, False),  # Cout 40
              (B, 7, 7, 512, 3, "none", bf, False),  # Cout 3, wide Cin
              (B, 13, 6, 64, 32, "relu", bf, False),  # a short last band
              (B, 9, 17, 64, 3, "leaky_relu", bf, False)]
    cases += [(b, h, h, cin, cout, act, bf, False)
              for b in (1, 2 * B) for (h, cin, cout, act) in ladder]
    total = {"ms": 0.0, "mma_ms": 0.0, "core_ms": 0.0, "plain_ms": 0.0,
             "library_ms": 0.0, "ops_ms": 0.0, "bytes_ms": 0.0,
             "bound_ms": 0.0, "max_abs_err": 0.0}
    for b, h, w, cin, cout, act, dt, main_path in cases:
        x = torch.randn(b, h, w, cin, generator=g, device=dev).to(dt)
        wt = torch.randn(cin, cout, 4, 4, generator=g, device=dev) \
            / math.sqrt(4 * cin)
        scale = torch.rand(cout, generator=g, device=dev) + 0.5
        shift = 0.1 * torch.randn(cout, generator=g, device=dev)
        wp = pack_convt_weight(wt, dt)
        mma = uses_mma(dt, cin)
        check(mma == (dt == torch.bfloat16), (cin, dt))
        route = convt_route(dt, h, w, cin, cout)
        kernels.reset_launch_counts()
        got = convt4x4s2_fused_cuda(x, wp, scale, shift, act)
        check(kernels.LAUNCHES["convt4x4s2_mma"] == int(mma)
              and all(kernels.LAUNCHES[f"convt4x4s2_{d}"]
                      == (route.design == d) for d in ("wgmma", "band")),
              f"the route is not the one convt_route names: {route}, "
              f"{dict(kernels.LAUNCHES)}")
        ref = convt4x4s2_fused_ref(x, wp, scale, shift, act)
        torch.cuda.synchronize()
        check(got.shape == (b, 2 * h, 2 * w, cout) and got.dtype == dt,
              (got.shape, got.dtype))
        err = (got.float() - ref.float()).abs().max().item()
        tol = TOL[dt] * (1 + ref.float().abs().max().item())
        name = (f"{b}x{h}x{w}x{cin}->{2 * h}x{2 * w}x{cout} {act} {dt} "
                f"({route.design}, block_n {route.block_n}"
                + (f", rows {route.rows}" if route.rows else "") + ")")
        check(err <= tol, f"{name}: max |kernel - plain| {err} > {tol}")
        if main_path:
            check(route.design in ("wgmma", "band"), name)
        else:
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
        # the earlier designs on the same bf16 inputs: mma.sync, CUDA cores
        mma_ms = time_ms(lambda: ops.convt4x4s2_mma(
            x, wp, scale, shift, ACTS[act], mma_tiles(cin, cout).block_n))
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
              f"{route.design} {ms:.4f} ms ({flops / ms / 1e9:.1f} TFLOP/s),"
              f" mma.sync {mma_ms:.4f} ms, CUDA-core kernel {core_ms:.4f} "
              f"ms, plain {plain_ms:.4f} ms, conv_transpose2d+affine+act "
              f"{library_ms:.4f} ms, kernel / yardstick "
              f"{ms / library_ms:.3f}; {flops / 1e9:.3f} GFLOP, "
              f"{nbytes / 1e6:.3f} MB, bound {bound_ms:.4f} ms "
              f"({'operations' if ops_ms >= bytes_ms else 'bytes'}), "
              f"kernel / bound {ms / bound_ms:.2f}")
        for k, v in (("ms", ms), ("mma_ms", mma_ms), ("core_ms", core_ms),
                     ("plain_ms", plain_ms), ("library_ms", library_ms),
                     ("ops_ms", ops_ms), ("bytes_ms", bytes_ms),
                     ("bound_ms", bound_ms)):
            total[k] += v
        total["max_abs_err"] = max(total["max_abs_err"], err)
    # NaN and +-inf through the f32 CUDA-core route, as the plain version
    # has them (ROADMAP C7: its relu once mapped a NaN sum to 0)
    for b, h, w, cin, cout in ((B, 7, 7, 1024, 512), (2, 13, 6, 64, 32),
                               (1, 9, 17, 33, 3)):
        for act in ACTS:
            x = torch.randn(b, h, w, cin, generator=g, device=dev)
            x[0, 0, w - 1, 1] = float("nan")
            x[0, h - 1, 0, 3] = float("inf")
            x[b - 1, h // 2, w // 2, 7] = float("-inf")
            wp = pack_convt_weight(torch.randn(
                cin, cout, 4, 4, generator=g, device=dev)
                / math.sqrt(4 * cin), torch.float32)
            scale = torch.rand(cout, generator=g, device=dev) + 0.5
            shift = 0.1 * torch.randn(cout, generator=g, device=dev)
            check(convt_route(torch.float32, h, w, cin, cout).design
                  == "core", (h, w, cin, cout))
            got = convt4x4s2_fused_cuda(x, wp, scale, shift, act)
            ref = convt4x4s2_fused_ref(x, wp, scale, shift, act)
            torch.cuda.synchronize()
            nan, inf, fin = ref.isnan(), ref.isinf(), ref.isfinite()
            err = (got[fin] - ref[fin]).abs().max().item()
            tol = TOL[torch.float32] * (1 + ref[fin].abs().max().item())
            check(nan.any() and inf.any() and fin.any()
                  and torch.equal(got.isnan(), nan)
                  and torch.equal(got.isinf(), inf)
                  and torch.equal(got[inf], ref[inf]) and err <= tol,
                  f"f32 {b}x{h}x{w}x{cin}->{cout} {act} non-finite: NaN "
                  f"{int(got.isnan().sum())} vs {int(nan.sum())}, inf "
                  f"{int(got.isinf().sum())} vs {int(inf.sum())}, finite "
                  f"err {err:.3g} (tol {tol:.3g})")
    print("f32 CUDA-core route with NaN and +-inf planted in x: NaN where "
          "the plain version has NaN, +-inf where it has them, every act "
          "(3 shapes)")
    print(f"5 bf16 layers: kernel {total['ms']:.4f} ms, mma.sync "
          f"{total['mma_ms']:.4f} ms, CUDA-core kernel "
          f"{total['core_ms']:.4f} ms, conv_transpose2d+affine+act "
          f"{total['library_ms']:.4f} ms, kernel / yardstick "
          f"{total['ms'] / total['library_ms']:.3f}, bound "
          f"{total['bound_ms']:.4f} ms, kernel / bound "
          f"{total['ms'] / total['bound_ms']:.2f}")
    return {
        "name": "convt4x4s2_fused", "route": "cuda",
        "source": "xgan_torch/kernels/csrc/convt4x4s2_wgmma.cu,"
                  "xgan_torch/kernels/csrc/convt4x4s2_band.cu,"
                  "xgan_torch/kernels/csrc/convt4x4s2_mma.cu,"
                  "xgan_torch/kernels/csrc/convt4x4s2.cu",
        "replaces": "xgan/ops/pallas/convt.py:101",
        "launches": 0, "max_abs_err": total["max_abs_err"],
        "ms": total["ms"], "plain_ms": total["plain_ms"],
        "bound_ms": total["bound_ms"],
        "bound_by": ("operations" if total["ops_ms"] >= total["bytes_ms"]
                     else "bytes"),
        "library_ms": total["library_ms"],
    }


def random_generator_pth(path: str, generator_cls=None):
    """Seeded random weights of a ``generator_cls`` generator (default the
    DCGAN one) in the reference layout, scaled so every layer keeps unit
    gain (the images then span the u8 range), with random BN running
    statistics."""
    from xgan_torch.models.dcgan import SEQ_BN, SEQ_CONVT, Generator
    g = torch.Generator().manual_seed(0)
    model = (generator_cls or Generator)(LATENT, 3, FG, SIZE, generator=g)
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
    check(on_new_designs(launches, want),
          f"{launches}: expected all {want} launches on the warpgroup "
          "designs")
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


# idle host time on each side of a counted profiler window's work: the
# profiler keeps only the kernels whose start and end, mapped from the
# card's clock onto the host's, fall inside the window, and that mapping
# can be off by milliseconds either way, by one amount for the whole
# window (C6, ROADMAP.md)
WINDOW_PAD_S = 0.5


def padded(fn) -> None:
    """``fn()`` and a synchronise, with :data:`WINDOW_PAD_S` of idle host
    time before and after."""
    time.sleep(WINDOW_PAD_S)
    fn()
    torch.cuda.synchronize()
    time.sleep(WINDOW_PAD_S)


def window_edges(events) -> str:
    """How far the first kernel of a profiled window starts after the
    window opened and the last ends before it closed; each should be about
    :data:`WINDOW_PAD_S`, and the difference is the clocks' disagreement."""
    from torch.autograd import DeviceType
    kernels = [e for e in events if e.device_type == DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False)
               and not e.name.startswith("ProfilerStep")]
    host_end = max(e.time_range.end for e in events
                   if e.device_type == DeviceType.CPU)
    if not kernels:
        return "profiled window: no kernel"
    head = min(e.time_range.start for e in kernels) / 1e3
    tail = (host_end - max(e.time_range.end for e in kernels)) / 1e3
    return (f"profiled window: the first kernel starts {head:.3f} ms after "
            f"it opened, the last ends {tail:.3f} ms before its last host "
            f"event ({WINDOW_PAD_S * 1e3:.0f} ms idle on each side)")


def warm_profile(warm, active):
    """torch.profiler (CPU and CUDA) over ``active()``, after a call of
    ``warm()`` with the profiler already on and its events dropped, each
    :func:`padded`. Returns (the events of ``active``, their key
    averages), without the step's own annotation, which the trace also
    lays on the device's timeline across the whole window; prints
    :func:`window_edges`."""
    from torch.profiler import ProfilerActivity, profile, schedule

    def ours(e, name):
        return not (getattr(e, "is_user_annotation", False)
                    or name.startswith("ProfilerStep"))

    got = {}

    def ready(p):
        events = p.events()
        print(window_edges(events))
        got.update(events=[e for e in events if ours(e, e.name)],
                   averages=[a for a in p.key_averages() if ours(a, a.key)])

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1),
                 on_trace_ready=ready) as prof:
        for fn in (warm, active):
            padded(fn)
            prof.step()
    return got["events"], got["averages"]


def phase_profile():
    """One sampler batch under torch.profiler: 5 convt4x4s2 kernels and no
    cuDNN convolution; prints the device-time breakdown."""
    from torch.autograd import DeviceType
    from xgan_torch.data.pipeline import tanh_to_u8
    from xgan_torch.models.dcgan import Generator
    model = Generator(LATENT, 3, FG, SIZE, dtype=torch.bfloat16,
                      device="cuda")
    z = torch.randn(B, LATENT, device="cuda")
    tanh_to_u8(model(z))
    torch.cuda.synchronize()
    wall = []

    def batch():
        t0 = time.perf_counter()
        tanh_to_u8(model(z))
        torch.cuda.synchronize()
        wall.append((time.perf_counter() - t0) * 1e3)

    events, averages = warm_profile(batch, batch)
    wall_ms = wall[-1]
    kernels = [e for e in events if e.device_type == DeviceType.CUDA]
    ours = [e for e in kernels if "convt4x4s2" in e.name]
    conv = [e.name for e in kernels if "convt4x4s2" not in e.name
            and ("cudnn" in e.name.lower() or "conv" in e.name.lower())]
    busy_ms = sum(e.device_time for e in kernels) / 1e3
    ours_ms = sum(e.device_time for e in ours) / 1e3
    print(f"profile of one batch: {len(kernels)} kernels, {busy_ms:.3f} ms "
          f"device time ({ours_ms:.3f} ms in {len(ours)} convt4x4s2), "
          f"{wall_ms:.3f} ms wall under the profiler")
    top = sorted(averages, key=lambda e: -e.self_device_time_total)
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
    with unfilter_routes() as routes:
        t0 = time.perf_counter()
        train = ImageStore.build(rsna.train_paths(root, ids), labels, SIZE,
                                 workers=8, compiled=True)
        dt = time.perf_counter() - t0
    check(routes == {"compiled": len(ids)}, dict(routes))
    print(f"store build: {len(ids)} PNGs {RAW_SIZE} px -> {SIZE} px in "
          f"{dt:.3f} s ({dt / len(ids) * 1e3:.3f} ms per image, 8 "
          "threads, the compiled unfilter)")
    check(train.images.shape == (N_TRAIN, SIZE, SIZE, 3)
          and train.images.std() > 10, "train store is wrong")
    synth = decode_folder_store(synth_dir, SIZE, workers=8, compiled=True)
    check(len(synth) == NUM_IMAGES, len(synth))
    return train, synth


# ---- PNGs of every kind, and the compiled row unfilter ---------------------

PNG_SIG = b"\x89PNG\r\n\x1a\n"
PNG_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4),
         (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))


def _png_chunk(kind: bytes, data: bytes) -> bytes:
    import struct
    import zlib
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def _pack_samples(samples: np.ndarray, depth: int) -> np.ndarray:
    """(h, n) sample values -> (h, stride) bytes, big-endian at 16 bits,
    most significant bits first below 8."""
    h, n = samples.shape
    if depth == 16:
        return samples.astype(">u2").view(np.uint8).reshape(h, 2 * n)
    if depth == 8:
        return samples.astype(np.uint8)
    per = 8 // depth
    s = np.zeros((h, -(-n // per) * per), np.uint8)
    s[:, :n] = samples
    shifts = (8 - depth * (np.arange(per) + 1)).astype(np.uint8)
    return (s.reshape(h, -1, per) << shifts).sum(-1, dtype=np.uint8)


def _filter_rows(rows: np.ndarray, bpp: int, filters) -> np.ndarray:
    """PNG-filter each row of ``rows`` (h, stride) with the types of
    ``filters`` in turn (0 None, 1 Sub, 2 Up, 3 Average, 4 Paeth);
    vectorized, since a filter reads the unfiltered bytes."""
    r = rows.astype(np.int16)
    left = np.zeros_like(r)
    left[:, bpp:] = r[:, :-bpp]
    up = np.zeros_like(r)
    up[1:] = r[:-1]
    ul = np.zeros_like(r)
    ul[1:, bpp:] = r[:-1, :-bpp]
    p = left + up - ul
    pa, pb, pc = np.abs(p - left), np.abs(p - up), np.abs(p - ul)
    paeth = np.where((pa <= pb) & (pa <= pc), left,
                     np.where(pb <= pc, up, ul))
    preds = (np.zeros_like(r), left, up, (left + up) >> 1, paeth)
    kinds = np.resize(np.asarray(filters, np.uint8), rows.shape[0])
    out = np.empty((rows.shape[0], rows.shape[1] + 1), np.uint8)
    out[:, 0] = kinds
    for f in range(5):
        sel = kinds == f
        out[sel, 1:] = ((r[sel] - preds[f][sel]) & 0xFF).astype(np.uint8)
    return out


def png_bytes(samples: np.ndarray, ctype: int, depth: int, *,
              interlace: bool = False, filters=(0,),
              palette=None) -> bytes:
    """A PNG of ``samples`` (h, w, channels) (palette indices for colour
    type 3), written with numpy and zlib at any colour type, bit depth,
    row filters and Adam7 interlace."""
    import struct
    import zlib
    h, w, ch = samples.shape
    bpp = max(1, ch * depth // 8)

    def image(s):
        hh, ww = s.shape[:2]
        if not hh or not ww:
            return b""
        rows = _pack_samples(s.reshape(hh, ww * ch), depth)
        return _filter_rows(rows, bpp, filters).tobytes()

    raw = (b"".join(image(samples[y0::dy, x0::dx])
                    for x0, y0, dx, dy in ADAM7)
           if interlace else image(samples))
    out = PNG_SIG + _png_chunk(b"IHDR", struct.pack(
        ">IIBBBBB", w, h, depth, ctype, 0, 0, int(interlace)))
    if palette is not None:
        out += _png_chunk(b"PLTE", np.asarray(palette, np.uint8).tobytes())
    return (out + _png_chunk(b"IDAT", zlib.compress(raw, 6))
            + _png_chunk(b"IEND", b""))


def xray_like(rng, n: int, size: int) -> np.ndarray:
    """``n`` smooth (size, size) grey images in [0, 1] with noise, whose
    Paeth and Average rows do not compress to nothing."""
    yy, xx = np.mgrid[0:size, 0:size] / size
    out = []
    for _ in range(n):
        f = rng.uniform(2, 9, 2)
        img = (0.5 + 0.3 * np.sin(f[0] * xx * 6) * np.cos(f[1] * yy * 6)
               + 0.02 * rng.standard_normal((size, size)))
        out.append(np.clip(img, 0, 1))
    return np.stack(out)


PNG_SIZE, PNG_THREADS = 1024, 8


def phase_png(tmp: str, smi: str) -> None:
    """The store's decode of every PNG kind and the compiled unfilter:

    - the compiled op ``png_unfilter`` bitwise against the plain version
      on random rows of every filter type at every bytes-per-pixel 1-8,
      and on the rows of a 1024-px Paeth and an Average image;
    - the store's decode (compiled) of Paeth, Average, 16-bit grey and
      RGB, 2-bit grey, 4-bit palette and interlaced PNGs bitwise against
      the plain path's, and the analyzer's rule (16-bit grey clipped);
    - ms per image of the decode and of the store build (decode + resize
      to 224) of 1024-px Paeth and Average grey PNGs on 1 and on 8
      threads (the better of two rounds), and the plain unfilter's decode
      of one image: 8 decodes on 8 threads must take under 4 times one
      decode on 1 (8 times would be no parallelism at all)."""
    from xgan_torch.data.store import ImageStore
    from xgan_torch.native import png as png_mod
    dev_dir = os.path.join(tmp, "pngs")
    os.makedirs(dev_dir)
    rng = np.random.default_rng(41)

    # the op against the plain version, every filter type and bpp
    from xgan_torch.kernels.build import load_ops
    op = load_ops().png_unfilter
    n = 0
    for bpp in range(1, 9):
        for kind in range(5):
            for stride in (bpp, 3 * bpp, 64 * bpp):
                raw = rng.integers(0, 256, (7, 1 + stride), dtype=np.uint8)
                raw[:, 0] = kind
                raw[3, 0] = rng.integers(0, 5)
                got = op(torch.from_numpy(raw), 7, stride, bpp).numpy()
                check(np.array_equal(got, png_mod._unfilter(raw, 7, stride,
                                                            bpp)),
                      ("png_unfilter", bpp, kind, stride))
                n += 1
    try:
        bad = np.zeros((2, 5), np.uint8)
        bad[1, 0] = 9
        op(torch.from_numpy(bad), 2, 4, 1)
    except ValueError:
        pass
    else:
        raise AssertionError("png_unfilter took filter type 9")

    grey = (xray_like(rng, 2 * PNG_THREADS, PNG_SIZE) * 255).astype(np.uint8)
    kinds = {}
    for j, (f, name) in enumerate(((4, "paeth"), (3, "average"))):
        paths = []
        for i in range(PNG_THREADS):
            p = os.path.join(dev_dir, f"{name}{i}.png")
            with open(p, "wb") as fh:
                fh.write(png_bytes(grey[j * PNG_THREADS + i, ..., None], 0,
                                   8, filters=(f,)))
            paths.append(p)
        kinds[name] = paths
    import zlib
    for name in ("paeth", "average"):  # the rows of a 1024-px image
        with open(kinds[name][0], "rb") as fh:
            data = fh.read()
        idat = data[data.index(b"IDAT") + 4:data.rindex(b"IEND") - 8]
        raw = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(
            PNG_SIZE, 1 + PNG_SIZE)
        check(np.array_equal(op(torch.from_numpy(raw.copy()), PNG_SIZE,
                                PNG_SIZE, 1).numpy(),
                             png_mod._unfilter(raw, PNG_SIZE, PNG_SIZE, 1)),
              f"png_unfilter on the {name} rows")
    print(f"png_unfilter: bitwise equal to the plain version on {n} random "
          f"row sets (filter types 0-4 each, bpp 1-8) and on the rows of a "
          f"{PNG_SIZE}-px Paeth and Average image; filter type 9 raises "
          "ValueError")

    # every kind through the store's decode, compiled against plain
    small = 96
    cases = {
        "16-bit grey": (rng.integers(0, 65536, (small, small, 1)), 0, 16,
                        False, None),
        "16-bit RGB": (rng.integers(0, 65536, (small, small, 3)), 2, 16,
                       False, None),
        "2-bit grey": (rng.integers(0, 4, (small, small, 1)), 0, 2, False,
                       None),
        "4-bit palette": (rng.integers(0, 16, (small, small, 1)), 3, 4,
                          False, rng.integers(0, 256, (16, 3))),
        "interlaced RGB": (rng.integers(0, 256, (small, small, 3)), 2, 8,
                           True, None),
        "interlaced 16-bit grey+alpha": (
            rng.integers(0, 65536, (small, small, 2)), 4, 16, True, None),
    }
    for name, (s, ctype, depth, inter, pal) in cases.items():
        p = os.path.join(dev_dir, name.replace(" ", "_") + ".png")
        with open(p, "wb") as fh:
            fh.write(png_bytes(s, ctype, depth, interlace=inter,
                               filters=(0, 1, 2, 3, 4), palette=pal))
        got = png_mod.decode_png(p, compiled=True)
        want = png_mod.decode_png(p)
        check(np.array_equal(got, want) and got.shape == (small, small, 3)
              and got.std() > 0, name)
        check(np.array_equal(png_mod.decode_png(p, grey16="clip",
                                                compiled=True),
                             png_mod.decode_png(p, grey16="clip")), name)
    for j, name in enumerate(kinds):
        check(np.array_equal(png_mod.decode_png(kinds[name][0],
                                                compiled=True),
                             np.repeat(grey[j * PNG_THREADS, ..., None], 3,
                                       2)), f"{name} decode")
    print(f"store decode, compiled unfilter vs plain: bitwise equal on "
          f"{PNG_SIZE}-px Paeth and Average grey and on "
          + ", ".join(cases) + f" ({small} px, filter types 0-4 in turn), "
          "with the store's and the analyzer's 16-bit rules")

    # ms per image on 1 and on 8 threads: the decode alone (what the GIL
    # would serialise) and the store build (decode + resize to 224)
    from concurrent.futures import ThreadPoolExecutor

    def decode_all(paths, threads):
        with ThreadPoolExecutor(threads) as pool:
            list(pool.map(lambda p: png_mod.decode_png(p, compiled=True),
                          paths))

    def store_all(paths, threads):
        store = ImageStore.build(paths, np.zeros(len(paths), np.int32),
                                 SIZE, workers=threads, compiled=True)
        check(store.images.std() > 10, "store build")

    times = {}
    for name, paths in kinds.items():
        for what, fn in (("decode", decode_all), ("store", store_all)):
            for threads in (1, PNG_THREADS, 1, PNG_THREADS):
                with unfilter_routes() as routes:
                    t0 = time.perf_counter()
                    fn(paths, threads)
                    dt = (time.perf_counter() - t0) / len(paths)
                # the better of two rounds: the host's cores are shared
                times[name, what, threads] = min(
                    dt, times.get((name, what, threads), dt))
                check(routes == {"compiled": len(paths)}, dict(routes))
    t0 = time.perf_counter()
    png_mod.decode_png(kinds["paeth"][0])
    plain_ms = (time.perf_counter() - t0) * 1e3
    for name in kinds:
        d1, d8 = (times[name, "decode", t] for t in (1, PNG_THREADS))
        s1, s8 = (times[name, "store", t] for t in (1, PNG_THREADS))
        print(f"{PNG_THREADS} {PNG_SIZE}-px {name} grey PNGs, compiled "
              f"unfilter: decode {d1 * 1e3:.3f} ms per image on 1 thread, "
              f"{d8 * 1e3:.3f} on {PNG_THREADS} ({PNG_THREADS} images in "
              f"{PNG_THREADS * d8 / d1:.2f}x the time of one); store build "
              f"(decode + resize to {SIZE} px, torch's own threads in the "
              f"resize) {s1 * 1e3:.3f} ms per image on 1 thread, "
              f"{s8 * 1e3:.3f} on {PNG_THREADS} [{smi}]")
        check(d8 < 0.5 * d1, f"{name}: {PNG_THREADS} decodes on "
              f"{PNG_THREADS} threads took {PNG_THREADS * d8 / d1:.2f}x one "
              "decode on 1 thread")
    print(f"the plain (Python) unfilter's decode of one {PNG_SIZE}-px Paeth "
          f"PNG: {plain_ms:.1f} ms")


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


def check_figures(figures_dir: str, names: list) -> None:
    """The directory holds exactly ``names``, each a PNG that decodes to a
    figure that is not blank."""
    from xgan_torch.native.png import decode_png
    check(sorted(os.listdir(figures_dir)) == sorted(names),
          (sorted(os.listdir(figures_dir)), names))
    for name in names:
        img = decode_png(os.path.join(figures_dir, name))
        check(img.ndim == 3 and img.shape[2] == 3 and img.std() > 0,
              (name, img.shape))


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
                "--figures-dir", os.path.join(out, "figures"),
                "--cache-dir", os.path.join(tmp, "cache"),
                "--image-size", str(SIZE), "--batch-size", str(CLS_B),
                "--compute-dtype", "bf16", "--workers", "8", *extra]
        kernels.reset_launch_counts()
        with unfilter_routes() as routes:
            t0 = time.perf_counter()
            result = classifier_main(argv)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        launches = dict(kernels.LAUNCHES)
        # a card run decodes its stores (run B: from run A's cache) with
        # the compiled PNG unfilter only
        check(routes == ({"compiled": N_TRAIN + N_TEST + NUM_IMAGES}
                         if run == "A" else {}), dict(routes))
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
        kinds = ["loss_curve", "accuracy_curve", "synthetic_ratio_curve"]
        if run == "A":
            kinds += ["cv_test_metrics_per_fold", "cv_test_loss_per_fold"]
        figures = sorted(f"{strategy}_{k}.png" for k in kinds)
        check_figures(os.path.join(out, "figures"), figures)
        print(f"run {run}: {sorted(os.listdir(mdir))} have the reference "
              f"keys; {sorted(ckpts)} load strictly; {figures} decode")
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
    one mixed_gather launch per step, the device idle share."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from xgan_torch import kernels as launches
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
        launches.reset_launch_counts()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            step(35)
            torch.cuda.synchronize()
        # the wrapper's count, not the trace: a trace can miss a kernel
        check(launches.LAUNCHES["mixed_gather"] == 1,
              f"mixed_gather launches in one step: {dict(launches.LAUNCHES)}")
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
        out[run] = step_ms
    return out


GAN_B, GAN_EPOCHS = 128, 2  # the reference's batch; 512 images: 4 steps
GAN_HISTORY_KEYS = {"G_losses_iter", "D_losses_iter", "D_x_iter",
                    "D_G_z1_iter", "D_G_z2_iter", "G_losses_epoch",
                    "D_losses_epoch"}


def phase_gan(tmp: str, root: str):
    """DCGAN training through its CLI at full width (224 px, fg = fd =
    64, latent 100, B = 128, bf16) on the RSNA tree, then the sampler CLI
    on its ``generator_final.pth``. Returns the ConvT launches of both
    runs."""
    from xgan_torch import kernels
    from xgan_torch.cli.generate_synthetic import main as sample_main
    from xgan_torch.cli.train_gan import main as gan_main
    from xgan_torch.models.dcgan import Discriminator, Generator
    from xgan_torch.native.png import decode_png
    out = os.path.join(tmp, "gan")
    argv = ["--data-dir", root, "--model-dir", os.path.join(out, "models"),
            "--output-dir", os.path.join(out, "results"),
            "--results-dir", os.path.join(out, "metrics"),
            "--figures-dir", os.path.join(out, "figures"),
            "--cache-dir", os.path.join(tmp, "cache"), "--workers", "8",
            "--image-size", str(SIZE), "--feature-maps-g", str(FG),
            "--feature-maps-d", str(FG), "--latent-dim", str(LATENT),
            "--batch-size", str(GAN_B), "--epochs", str(GAN_EPOCHS),
            "--compute-dtype", "bf16", "--save-interval", "4",
            "--checkpoint-interval", "1"]
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    history = gan_main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    steps = GAN_EPOCHS * math.ceil(N_TRAIN / GAN_B)
    sheet_dir = os.path.join(out, "results", "gan_images")
    sheets = sorted(os.listdir(sheet_dir))
    want = 5 * (steps + len(sheets))
    print(f"GAN run: {wall:.1f} s wall, {steps} train steps, "
          f"{len(sheets)} sample sheets, launches {launches}; last "
          f"metrics G {history['G_losses_iter'][-1]:.4f} D "
          f"{history['D_losses_iter'][-1]:.4f} D(x) "
          f"{history['D_x_iter'][-1]:.4f}")
    check(launches.get("convt4x4s2_fused", 0) == want, (launches, want))
    check(on_new_designs(launches, want),
          f"{launches}: expected all {want} launches on the warpgroup "
          "designs")
    with open(os.path.join(out, "metrics", "gan_training_history.json")) \
            as f:
        saved = json.load(f)
    check(set(saved) == GAN_HISTORY_KEYS, sorted(saved))
    for key, series in saved.items():
        check(len(series) == (steps if key.endswith("_iter")
                              else GAN_EPOCHS), (key, len(series)))
        check(all(math.isfinite(v) for v in series), (key, series))
    check(sheets == ["fake_samples_epoch_001_iter_000000.png",
                     "fake_samples_epoch_002_iter_000004.png",
                     "fake_samples_epoch_002_iter_000007.png"], sheets)
    side = 8 * (SIZE + 2) + 2  # 64 images, 8 per row, 2 px padding
    for name in sheets:
        img = decode_png(os.path.join(sheet_dir, name))
        check(img.shape == (side, side, 3), (name, img.shape))
    check_figures(os.path.join(out, "figures"), ["gan_loss_curve.png"])
    gan_dir = os.path.join(out, "models", "gan")
    for name, model in (("generator_final.pth", Generator(LATENT, 3, FG,
                                                           SIZE)),
                        ("discriminator_final.pth",
                         Discriminator(3, FG, SIZE))):
        model.load_state_dict(torch.load(os.path.join(gan_dir, name),
                                         weights_only=True), strict=True)
    print(f"GAN run: history keys and {steps} finite entries per series; "
          f"{len(sheets)} sheets of {side}x{side} and gan_loss_curve.png "
          "decode; "
          f"{sorted(os.listdir(gan_dir))} load strictly")

    # the chain of the main path: the trained generator into the sampler
    kernels.reset_launch_counts()
    stats = sample_main([
        "--model-path", os.path.join(gan_dir, "generator_final.pth"),
        "--output-dir", os.path.join(out, "synthetic"),
        "--num-images", str(B), "--latent-dim", str(LATENT),
        "--feature-maps-g", str(FG), "--image-size", str(SIZE),
        "--batch-size", str(B), "--compute-dtype", "bf16"])
    torch.cuda.synchronize()
    chain = dict(kernels.LAUNCHES)
    check(stats["written"] == B and on_new_designs(chain, 5),
          (stats, chain))
    img = decode_png(os.path.join(out, "synthetic", f"synthetic_{B:05d}.png"))
    check(img.shape == (SIZE, SIZE, 3), img.shape)
    print(f"GAN -> sampler: {stats['written']} images from the trained "
          f"generator_final.pth, launches {chain}")
    return want + chain.get("convt4x4s2_fused", 0)


def phase_analyzer(tmp: str, root: str, synth_dir: str, smi: str):
    """Runs A and B gathered into one metrics and one model directory
    (the CV run's fold-1 checkpoint as ``curriculum_resnet50.pth``), the
    analyzer CLI on the card at full width, its outputs decoded and its
    report held against ``--cpu``'s; SSIM and one conv3 CAM on the card
    held against the CPU; the SSIM, CAM and CLI times."""
    import shutil
    from xgan_torch.analysis import (_load_grayscale, gradcam_samples,
                                     grad_cam_resnet, load_cam_models,
                                     ssim_picks)
    from xgan_torch.cli.analyze_results import main as analyze_main
    from xgan_torch.data.pipeline import IMAGENET_MEAN, IMAGENET_STD
    from xgan_torch.data.store import resize_u8
    from xgan_torch.native.png import decode_png
    from xgan_torch.ops.ssim import mean_ssim_per_synthetic
    metrics = os.path.join(tmp, "analyzer_in", "metrics")
    models = os.path.join(tmp, "analyzer_in", "models")
    os.makedirs(models)
    shutil.copytree(os.path.join(tmp, "runA", "metrics"), metrics)
    for name in os.listdir(os.path.join(tmp, "runB", "metrics")):
        shutil.copy(os.path.join(tmp, "runB", "metrics", name), metrics)
    shutil.copy(os.path.join(tmp, "runA", "models",
                             "fold_1_curriculum_resnet50.pth"),
                os.path.join(models, "curriculum_resnet50.pth"))
    shutil.copy(os.path.join(tmp, "runB", "models",
                             "augmented_resnet50.pth"), models)
    argv = ["--metrics-dir", metrics, "--model-dir", models,
            "--data-dir", root, "--synthetic-dir", synth_dir,
            "--image-size", str(SIZE)]
    out = os.path.join(tmp, "analysis")
    t0 = time.perf_counter()
    analyze_main(argv + ["--analysis-dir", out])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    samples = gradcam_samples(root, synth_dir, 3)
    panels = [f"gradcam_{s['type']}_{s['patientId']}.png" for s in samples]
    check([s["type"] for s in samples] == ["real_positive"] * 3
          + ["real_negative"] * 3 + ["synthetic"] * 3, samples)
    want = sorted(["comparison_acc.png", "comparison_loss.png",
                   "comparison_synthetic_ratio.png", "cv_comparison.png",
                   "comparison_report.txt", "ssim_distribution.png"]
                  + panels)
    check(sorted(os.listdir(out)) == want, sorted(os.listdir(out)))
    for name in want:
        if name.endswith(".png"):
            img = decode_png(os.path.join(out, name))
            check(img.ndim == 3 and img.std() > 0, (name, img.shape))
    cpu_out = os.path.join(tmp, "analysis_cpu")
    analyze_main(argv + ["--analysis-dir", cpu_out, "--cpu", "--skip-plots",
                         "--skip-ssim", "--skip-gradcam"])
    with open(os.path.join(out, "comparison_report.txt"), "rb") as f:
        report = f.read()
    with open(os.path.join(cpu_out, "comparison_report.txt"), "rb") as f:
        check(report == f.read(), "the card's report differs from --cpu's")
    check(b"* Curriculum:" in report and b"* Augmented:" in report, report)

    # SSIM: all pairs on the card by CUDA events, 20 x 10 against the CPU
    real_paths, synth_paths = ssim_picks(root, synth_dir, 100, 500)
    t0 = time.perf_counter()
    real = torch.from_numpy(_load_grayscale(real_paths, SIZE))
    synth = torch.from_numpy(_load_grayscale(synth_paths, SIZE))
    load_s = time.perf_counter() - t0
    n_real = min(100, -(-N_TRAIN // 3))  # every third train image positive
    check(real.shape == (n_real, SIZE, SIZE)
          and synth.shape == (500, SIZE, SIZE), (real.shape, synth.shape))
    real_d, synth_d = real.cuda(), synth.cuda()
    scores = mean_ssim_per_synthetic(synth_d, real_d)
    ssim_ms = time_ms(lambda: mean_ssim_per_synthetic(synth_d, real_d),
                      reps=1)
    check(bool(torch.isfinite(scores).all()) and scores.shape == (500,),
          scores.shape)
    sub = mean_ssim_per_synthetic(synth_d[:20], real_d[:10]).cpu()
    sub_cpu = mean_ssim_per_synthetic(synth[:20], real[:10])
    ssim_err = (sub - sub_cpu).abs().max().item()
    check(ssim_err <= 1e-5, f"SSIM card vs CPU {ssim_err} > 1e-5")

    # one conv3 CAM on the card against the CPU; the time per CAM
    card = load_cam_models(models, device=torch.device("cuda"))["augmented"]
    cpu = load_cam_models(models, device=torch.device("cpu"))["augmented"]
    rgb = resize_u8(decode_png(samples[0]["path"]), SIZE) \
        .astype(np.float32) / 255.0
    normed = torch.from_numpy((rgb - IMAGENET_MEAN) / IMAGENET_STD)
    pred, cam = grad_cam_resnet(card, normed.cuda())
    pred_cpu, cam_cpu = grad_cam_resnet(cpu, normed)
    cam_err = float(np.abs(cam - cam_cpu).max())
    check(pred == pred_cpu and cam_err <= 5e-3,
          f"CAM card vs CPU: pred {pred} / {pred_cpu}, max |diff| {cam_err}")
    t0 = time.perf_counter()
    for _ in range(10):
        grad_cam_resnet(card, normed.cuda())
    cam_ms = (time.perf_counter() - t0) / 10 * 1e3
    print(f"analyzer: CLI {wall:.3f} s wall for the report, 4 plots, SSIM "
          f"of 500 x {n_real} at {SIZE} px and {len(panels)} Grad-CAM panels of "
          f"2 models; grey load of {len(real) + len(synth)} PNGs "
          f"{load_s:.3f} s (host); "
          f"all-pairs SSIM {ssim_ms:.3f} ms (CUDA events), mean "
          f"{scores.mean().item():.4f}; conv3 CAM {cam_ms:.3f} ms per image "
          f"(host clock, f32); SSIM card vs CPU (20 x 10) max |diff| "
          f"{ssim_err:.3g} (tol 1e-5), conv3 CAM {cam_err:.3g} (tol 5e-3), "
          f"pred {pred}; report equal to --cpu's; {smi}")


def gan_models(dtype, seed: int = 0, capturable: bool = False):
    """Seeded full-width G and D (fg = fd = 64, 224 px) on the card and
    their Adam optimizers (``capturable``: as the DCGAN trainer builds
    them on the card, for every ``--steps-per-call``)."""
    from xgan_torch.models.dcgan import Discriminator, Generator
    from xgan_torch.train.common import adam
    dev = torch.device("cuda")
    g = Generator(LATENT, 3, FG, SIZE, dtype=dtype, device=dev,
                  generator=torch.Generator(dev).manual_seed(seed))
    d = Discriminator(3, FG, SIZE, dtype=dtype, device=dev,
                      generator=torch.Generator(dev).manual_seed(seed + 1))
    return (g, d, adam(g.parameters(), 2e-4, 0.5, capturable=capturable),
            adam(d.parameters(), 2e-4, 0.5, capturable=capturable))


def gan_layer_inputs(b: int, dtype, seed: int, widths=None):
    """(x, w, grad of y) of each of the five k4s2 layers (of the ladder
    ``widths`` names, as in :func:`layer_shapes`) at batch ``b``: x (B, H,
    H, Cin) in ``dtype``, the f32 torch weight, the upstream gradient in
    ``dtype``."""
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed)
    out = []
    for h, cin, cout, _ in layer_shapes(widths):
        x = torch.randn(b, h, h, cin, generator=g, device=dev).to(dtype)
        w = torch.randn(cin, cout, 4, 4, generator=g, device=dev) \
            / math.sqrt(4 * cin)
        up = torch.randn(b, 2 * h, 2 * h, cout, generator=g, device=dev) \
            .to(dtype)
        out.append((x, w, up))
    return out


def phase_gan_step_check(train_store):
    """One f32 train step at full width (B = 16, TF32 off, deterministic
    cuDNN) with G's k4s2 forwards on the kernel and on the plain version,
    from the same weights and draws: metrics within 1e-4, G's per-tensor
    gradient norms within 1e-3 relative; a second kernel run gives the
    run-to-run floor. Then ``convt4x4s2_train`` forward and backward
    against ``F.conv_transpose2d`` under autograd at the five bf16 layers
    at B = 128."""
    import torch.nn.functional as F
    from xgan_torch.data.pipeline import DeviceStore
    from xgan_torch.kernels.convt import (convt4x4s2_fused_ref,
                                          convt4x4s2_train)
    from xgan_torch.train.gan import dcgan_step
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # cuDNN's default f32 backward algorithms sum with atomics, in another
    # order on every run
    torch.backends.cudnn.deterministic = True
    dev = torch.device("cuda")
    store = DeviceStore(train_store, dev)
    g = torch.Generator(device=dev).manual_seed(8)
    idx = torch.randint(0, len(store), (16,), generator=g, device=dev)
    flip = torch.rand(16, generator=g, device=dev) < 0.5
    noise = torch.randn(16, LATENT, generator=g, device=dev)
    runs = []
    for convt in (None, convt4x4s2_fused_ref, None):
        g_net, d_net, opt_g, opt_d = gan_models(torch.float32)
        kw = {} if convt is None else {"convt": convt}
        m = dcgan_step(g_net, d_net, opt_g, opt_d, store.images, idx,
                       latent_dim=LATENT, flip=flip, noise=noise, **kw)
        runs.append((m, torch.stack([p.grad.norm()
                                     for p in g_net.parameters()])))
    torch.backends.cudnn.deterministic = False
    (m_k, n_k), (m_p, n_p), (m_k2, n_k2) = runs
    m_err = (m_k - m_p).abs().max().item()
    rel = ((n_k - n_p).abs() / n_p).tolist()
    rel_floor = ((n_k - n_k2).abs() / n_k2).max().item()
    names = [n for n, _ in g_net.named_parameters()]
    worst = sorted(zip(rel, names), reverse=True)[:3]
    print(f"f32 GAN step (B=16), kernel vs plain G forward: metrics "
          f"{[round(v, 6) for v in m_k.tolist()]}, max |diff| {m_err:.3g} "
          f"(tol 1e-4; kernel vs kernel "
          f"{(m_k - m_k2).abs().max().item():.3g}); G gradient norms max "
          f"relative diff {max(rel):.3g} (tol 1e-3; kernel vs kernel "
          f"{rel_floor:.3g}); worst "
          + ", ".join(f"{n} {r:.3g}" for r, n in worst))
    check(m_err <= 1e-4, "f32 GAN step: kernel vs plain metrics differ")
    check(max(rel) <= 1e-3, "f32 GAN step: G gradient norms differ")

    tol = TOL[torch.bfloat16]
    for i, (x, w, up) in enumerate(gan_layer_inputs(GAN_B, torch.bfloat16,
                                                    seed=9)):
        xa, wa = x.clone().requires_grad_(), w.clone().requires_grad_()
        y = convt4x4s2_train(xa, wa)
        dx, dw = torch.autograd.grad(y, (xa, wa), up)
        xb, wb = x.clone().requires_grad_(), w.clone().requires_grad_()
        y_ref = F.conv_transpose2d(xb.permute(0, 3, 1, 2), wb.to(x.dtype),
                                   stride=2, padding=1).permute(0, 2, 3, 1)
        dx_ref, dw_ref = torch.autograd.grad(y_ref, (xb, wb), up)
        errs = []
        for got, want in ((y, y_ref), (dx, dx_ref), (dw, dw_ref)):
            want = want.float()
            bound = tol * (1 + want.abs().max().item())
            errs.append((got.float() - want).abs().max().item())
            check(errs[-1] <= bound, (i, errs, bound))
        print(f"convt4x4s2_train layer {i + 1} bf16 B={GAN_B}: max |diff| "
              f"vs F.conv_transpose2d autograd: y {errs[0]:.3g}, dx "
              f"{errs[1]:.3g}, dW {errs[2]:.3g}")


def phase_gan_profile(train_store):
    """20 warm bf16 train steps at B = 128: ms per step, imgs/s; one
    profiled step: top device ops, the ConvT kernel's share, the idle
    share. Then the five k4s2 forwards at the training shapes (act none,
    identity affine): the kernel, its plain version and cuDNN's
    ``F.conv_transpose2d`` by CUDA events, against the bound."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from xgan_torch import kernels
    from xgan_torch.data.pipeline import DeviceStore
    from xgan_torch.train.gan import dcgan_step
    dev = torch.device("cuda")
    store = DeviceStore(train_store, dev)
    g_net, d_net, opt_g, opt_d = gan_models(torch.bfloat16, seed=10)
    gen = torch.Generator(dev).manual_seed(11)
    idx = torch.randint(0, len(store), (24, GAN_B), generator=gen,
                        device=dev)

    def step(i):
        return dcgan_step(g_net, d_net, opt_g, opt_d, store.images, idx[i],
                          latent_dim=LATENT, dtype=torch.bfloat16,
                          generator=gen)

    for i in range(3):
        step(i)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(3, 23):
        m = step(i)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) / 20 * 1e3
    check(bool(torch.isfinite(m).all()), m)
    kernels.reset_launch_counts()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        padded(lambda: step(23))
    check(on_new_designs(kernels.LAUNCHES, 5), dict(kernels.LAUNCHES))
    print(window_edges(prof.events()))
    events = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    ours = [e for e in events if "convt4x4s2" in e.name]
    busy_ms = sum(e.device_time for e in events) / 1e3
    ours_ms = sum(e.device_time for e in ours) / 1e3
    print(f"GAN train step (bf16, B={GAN_B}, 224 px, fg = fd = 64): "
          f"{step_ms:.3f} ms per step (mean of 20 warm), "
          f"{GAN_B / step_ms * 1e3:.1f} imgs/s; profiled step: "
          f"{len(events)} kernels, {busy_ms:.3f} ms device time, "
          f"{len(ours)} convt4x4s2 kernels {ours_ms:.3f} ms (share "
          f"{ours_ms / busy_ms:.3f}); device idle share "
          f"~{1 - busy_ms / step_ms:.3f}")
    check(len(ours) == 5, [e.name for e in ours])
    top = sorted(prof.key_averages(), key=lambda e: -e.self_device_time_total)
    for e in top[:12]:
        if e.self_device_time_total > 0:
            print(f"  {e.self_device_time_total / 1e3:9.3f} ms  "
                  f"x{e.count:<3d} {e.key[:90]}")

    total = {"ms": 0.0, "mma_ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0,
             "bound_ms": 0.0}
    for i, (x, w, _) in enumerate(gan_layer_inputs(GAN_B, torch.bfloat16,
                                                   seed=12)):
        b, h, _, cin = x.shape
        cout = w.shape[1]
        t = convt_layer_times(x, w, torch.ones(cout, device=dev),
                              torch.zeros(cout, device=dev), "none")
        print(layer_line(f"train layer {i + 1} {b}x{h}x{h}x{cin}->{2 * h}x"
                         f"{2 * h}x{cout} none bf16", t, "cuDNN"))
        for k in total:
            total[k] += t[k]
    print(f"5 train layers (B={GAN_B}): kernel {total['ms']:.4f} ms, "
          f"mma.sync {total['mma_ms']:.4f} ms, plain "
          f"{total['plain_ms']:.4f} ms, F.conv_transpose2d "
          f"{total['library_ms']:.4f} ms, kernel / cuDNN "
          f"{total['ms'] / total['library_ms']:.3f}, bound "
          f"{total['bound_ms']:.4f} ms; kernel share of the step "
          f"{total['ms'] / step_ms:.3f}")


WGAN_B, WGAN_CRITIC, WGAN_STEPS = 64, 5, 4  # src/train_wggan.py defaults
WGAN_HISTORY_KEYS = {"D_losses", "G_losses", "D_losses_epoch",
                     "G_losses_epoch"}


def convt_layer_times(x, w, scale, shift, act: str) -> dict:
    """One k4s2 layer on the kernel (bf16: the tile table's design), held
    against its plain version within ``TOL``, then timed by CUDA events:
    the kernel, the ``mma.sync`` kernel on the same inputs (bf16), the
    plain version and the library call (cuDNN's ``F.conv_transpose2d``,
    plus the affine and the ReLU where the epilogue has them); the bound
    from the bytes (x, the packed weight, the output, scale and shift) and
    the FLOPs."""
    import torch.nn.functional as F
    from xgan_torch import kernels
    from xgan_torch.kernels.build import load_ops
    from xgan_torch.kernels.convt import (ACTS, convt4x4s2_fused,
                                          convt4x4s2_fused_ref, convt_route,
                                          mma_tiles, pack_convt_weight,
                                          uses_mma)
    b, h, _, cin = x.shape
    cout = w.shape[1]
    wp = pack_convt_weight(w, x.dtype)
    route = convt_route(x.dtype, h, h, cin, cout)
    kernels.reset_launch_counts()
    got = convt4x4s2_fused(x, wp, scale, shift, act)
    check(kernels.LAUNCHES["convt4x4s2_mma"] == int(uses_mma(x.dtype, cin))
          and (x.dtype != torch.bfloat16 or on_new_designs(
              kernels.LAUNCHES, 1)), ("the route is not the table's", route,
                                      dict(kernels.LAUNCHES)))
    ref = convt4x4s2_fused_ref(x, wp, scale, shift, act)
    err = (got.float() - ref.float()).abs().max().item()
    tol = TOL[x.dtype] * (1 + ref.float().abs().max().item())
    check(got.shape == (b, 2 * h, 2 * h, cout) and err <= tol,
          (tuple(got.shape), cin, cout, act, err, tol))
    wl, x_nchw = w.to(x.dtype), x.permute(0, 3, 1, 2)
    sc4, sh4 = scale.view(1, -1, 1, 1), shift.view(1, -1, 1, 1)
    identity = bool((scale == 1).all() and (shift == 0).all())

    def library():
        y = F.conv_transpose2d(x_nchw, wl, stride=2, padding=1)
        if act == "none" and identity:
            return y
        y = y.float() * sc4 + sh4
        return (torch.relu(y) if act == "relu" else y).to(x.dtype)

    out = {"err": err, "tol": tol, "design": route.design,
           "block_n": route.block_n, "rows": route.rows,
           "ms": time_ms(lambda: convt4x4s2_fused(x, wp, scale, shift, act)),
           "plain_ms": time_ms(lambda: convt4x4s2_fused_ref(
               x, wp, scale, shift, act), reps=3),
           "library_ms": time_ms(library)}
    if x.dtype == torch.bfloat16:
        ops = load_ops()
        out["mma_ms"] = time_ms(lambda: ops.convt4x4s2_mma(
            x, wp, scale, shift, ACTS[act], mma_tiles(cin, cout).block_n))
    flops = 2 * b * (2 * h) ** 2 * cout * 4 * cin
    nbytes = (x.numel() + wp.numel() + b * (2 * h) ** 2 * cout) \
        * x.element_size() + 2 * 4 * cout
    ops_ms, bytes_ms = flops / BF16_PEAK_FLOPS * 1e3, _bytes_ms(nbytes)
    out.update(flops=flops, bound_ms=max(ops_ms, bytes_ms),
               bound_by="operations" if ops_ms >= bytes_ms else "bytes")
    return out


def layer_line(label: str, t: dict, library: str) -> str:
    """One timed layer of :func:`convt_layer_times`: the design's time and
    rate beside mma.sync, the plain version, the library call and the
    bound."""
    tile = (f"rows {t['rows']}" if t["design"] == "band"
            else f"block_n {t['block_n']}")
    return (f"{label} ({t['design']}, {tile}): max_abs_err {t['err']:.3g} "
            f"(tol {t['tol']:.3g}); kernel {t['ms']:.4f} ms "
            f"({t['flops'] / t['ms'] / 1e9:.1f} TFLOP/s), mma.sync "
            f"{t['mma_ms']:.4f} ms, plain {t['plain_ms']:.4f} ms, {library} "
            f"{t['library_ms']:.4f} ms, kernel / {library} "
            f"{t['ms'] / t['library_ms']:.3f}; bound {t['bound_ms']:.4f} ms "
            f"({t['bound_by']}), kernel / bound "
            f"{t['ms'] / t['bound_ms']:.2f}")


def phase_wgan_kernels(smi: str):
    """The five k4s2 layers of the WGAN-GP G-224 ladder (1024 -> 512 at
    7x7 ... 64 -> 3 at 112x112) at B = 64: bf16 on the tensor-core kernel
    with the sampler's epilogue (BN folded into scale/shift and ReLU; the
    last layer act none) and with the train forward's (identity affine,
    act none), each against the plain version within TOL and timed
    against its bound, the plain version and cuDNN; f32 on the CUDA-core
    kernel against the plain version."""
    from xgan_torch.kernels.convt import (convt4x4s2_fused,
                                          convt4x4s2_fused_ref,
                                          pack_convt_weight)
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(15)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    for form in ("sampler", "train"):
        total = {"ms": 0.0, "mma_ms": 0.0, "plain_ms": 0.0,
                 "library_ms": 0.0, "bound_ms": 0.0}
        for i, (x, w, _) in enumerate(gan_layer_inputs(
                WGAN_B, torch.bfloat16, seed=16, widths=WGAN_WIDTHS)):
            b, h, _, cin = x.shape
            cout = w.shape[1]
            if form == "sampler":
                act = "relu" if i < 4 else "none"
                scale = torch.rand(cout, generator=g, device=dev) + 0.5
                shift = 0.1 * torch.randn(cout, generator=g, device=dev)
                if i == 4:
                    scale, shift = torch.ones_like(scale), \
                        torch.zeros_like(shift)
            else:
                act = "none"
                scale = torch.ones(cout, device=dev)
                shift = torch.zeros(cout, device=dev)
            t = convt_layer_times(x, w, scale, shift, act)
            library = "cuDNN" if form == "train" else "cuDNN+affine+act"
            print(layer_line(f"wgan {form} layer {i + 1} {b}x{h}x{h}x{cin}->"
                             f"{2 * h}x{2 * h}x{cout} {act} bf16", t,
                             library))
            for k in total:
                total[k] += t[k]
        print(f"wgan {form} form, 5 layers (B={WGAN_B}): kernel "
              f"{total['ms']:.4f} ms, mma.sync {total['mma_ms']:.4f} ms, "
              f"plain {total['plain_ms']:.4f} ms, "
              f"cuDNN {total['library_ms']:.4f} ms, kernel / cuDNN "
              f"{total['ms'] / total['library_ms']:.3f}, bound "
              f"{total['bound_ms']:.4f} ms; {smi}")
    # f32 on the CUDA-core kernel (the f32 step check's route)
    for i, (x, w, _) in enumerate(gan_layer_inputs(
            16, torch.float32, seed=17, widths=WGAN_WIDTHS)):
        wp = pack_convt_weight(w)
        ones = torch.ones(w.shape[1], device=dev)
        zeros = torch.zeros(w.shape[1], device=dev)
        got = convt4x4s2_fused(x, wp, ones, zeros, "relu")
        ref = convt4x4s2_fused_ref(x, wp, ones, zeros, "relu")
        err = (got - ref).abs().max().item()
        tol = TOL[torch.float32] * (1 + ref.abs().max().item())
        check(err <= tol, ("f32 wgan layer", i, err, tol))
    print("wgan f32 layers (B=16, CUDA-core kernel): within tol of plain")


def phase_wgan_sampler(tmp: str):
    """The WGAN-GP sampler through its CLI at full width (latent 100, fg
    64, 224 px, batch 64, bf16) from a seeded random-weight
    reference-layout ``.pth``: 512 PNGs, each decoded back, 5 tensor-core
    ConvT launches a batch; then one f32 batch of the kernel path against
    the plain-version path within 1 u8 level. Returns the launches."""
    from xgan_torch import kernels
    from xgan_torch.cli.generate_synthetic_wgan import main as sample_main
    from xgan_torch.data.pipeline import tanh_to_u8
    from xgan_torch.kernels.convt import convt4x4s2_fused_ref
    from xgan_torch.models.convert import load_generator_pth
    from xgan_torch.models.wgan import Generator
    from xgan_torch.native.png import decode_png
    pth = os.path.join(tmp, "wgan_generator.pth")
    random_generator_pth(pth, Generator)
    out_dir = os.path.join(tmp, "wgan_synthetic")
    kernels.reset_launch_counts()
    stats = sample_main([
        "--model-path", pth, "--output-dir", out_dir,
        "--num-images", str(NUM_IMAGES), "--latent-dim", str(LATENT),
        "--feature-maps-g", str(FG), "--image-size", str(SIZE),
        "--batch-size", str(B), "--compute-dtype", "bf16", "--seed", "0"])
    torch.cuda.synchronize()
    launches = dict(kernels.LAUNCHES)
    want = 5 * math.ceil(NUM_IMAGES / B)
    print(f"wgan sampler: {stats['written']} images, "
          f"{stats['imgs_per_sec']:.1f} imgs/s written, "
          f"{stats['device_plus_transfer_imgs_per_sec']:.1f} imgs/s "
          f"device+transfer; launches {launches}")
    check(launches.get("convt4x4s2_fused", 0) == want
          and on_new_designs(launches, want),
          f"{launches}: expected all {want} launches on the warpgroup "
          "designs")
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

    g32 = Generator(LATENT, 3, FG, SIZE, dtype=torch.float32, device="cuda")
    g32.load_state_dict(load_generator_pth(pth))
    z = torch.randn((B, LATENT), device="cuda",
                    generator=torch.Generator("cuda").manual_seed(0))
    u8_kernel = tanh_to_u8(g32(z))
    u8_plain = tanh_to_u8(g32(z, convt=convt4x4s2_fused_ref))
    d = (u8_kernel.int() - u8_plain.int()).abs()
    d16 = (first.int() - u8_kernel.cpu().int()).abs().float()
    print(f"wgan f32 batch kernel vs plain: max {d.max().item()} u8 levels, "
          f"{(d > 0).float().mean().item():.3g} of pixels differ; bf16 CLI "
          f"batch vs f32: mean {d16.mean().item():.3f}, max "
          f"{d16.max().item():.0f} levels; image std "
          f"{first.float().std().item():.1f} levels")
    check(d.max().item() <= 1, "wgan f32 kernel path vs plain path > 1 level")
    check(d16.mean().item() <= 2.0, "wgan bf16 images far from the f32 ones")
    return launches["convt4x4s2_fused"]


def phase_wgan_train(tmp: str, root: str):
    """WGAN-GP training through its CLI at full width (224 px, fg = fd =
    64, latent 100, B = 64, 5 critic updates a step, bf16) on the RSNA
    tree, 1 epoch cut to 4 steps, then the WGAN-GP sampler CLI on its
    ``generator_final.pth``. Returns the ConvT launches of both runs."""
    from xgan_torch import kernels
    from xgan_torch.cli.generate_synthetic_wgan import main as sample_main
    from xgan_torch.cli.train_wggan import main as wgan_main
    from xgan_torch.models.wgan import Critic, Generator
    from xgan_torch.native.png import decode_png
    out = os.path.join(tmp, "wgan")
    argv = ["--data-dir", root, "--model-dir", os.path.join(out, "models"),
            "--output-dir", os.path.join(out, "results"),
            "--results-dir", os.path.join(out, "metrics"),
            "--figures-dir", os.path.join(out, "figures"),
            "--cache-dir", os.path.join(tmp, "cache"), "--workers", "8",
            "--image-size", str(SIZE), "--feature-maps-g", str(FG),
            "--feature-maps-d", str(FG), "--latent-dim", str(LATENT),
            "--batch-size", str(WGAN_B), "--epochs", "1",
            "--limit-batches", str(WGAN_STEPS),
            "--critic-iters", str(WGAN_CRITIC), "--compute-dtype", "bf16"]
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    history = wgan_main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    sheet_dir = os.path.join(out, "results", "wgan_images")
    sheets = sorted(os.listdir(sheet_dir))
    want = 5 * ((WGAN_CRITIC + 1) * WGAN_STEPS + len(sheets))
    print(f"WGAN-GP run: {wall:.1f} s wall, {WGAN_STEPS} train steps of "
          f"{WGAN_CRITIC} critic updates, {len(sheets)} sample sheets, "
          f"launches {launches}; last losses D "
          f"{history['D_losses'][-1]:.4f} G {history['G_losses'][-1]:.4f}")
    check(launches.get("convt4x4s2_fused", 0) == want
          and on_new_designs(launches, want),
          f"{launches}: expected all {want} launches on the warpgroup "
          "designs")
    with open(os.path.join(out, "metrics", "wgan_training_history.json")) \
            as f:
        saved = json.load(f)
    check(set(saved) == WGAN_HISTORY_KEYS, sorted(saved))
    lengths = {"D_losses": WGAN_STEPS * WGAN_CRITIC, "G_losses": WGAN_STEPS,
               "D_losses_epoch": 1, "G_losses_epoch": 1}
    for key, series in saved.items():
        check(len(series) == lengths[key], (key, len(series)))
        check(all(math.isfinite(v) for v in series), (key, series))
    check(sheets == ["fake_samples_epoch_001_iter_000000.png",
                     f"fake_samples_epoch_001_iter_{WGAN_STEPS - 1:06d}.png"],
          sheets)
    side = 8 * (SIZE + 2) + 2  # 64 images, 8 per row, 2 px padding
    for name in sheets:
        img = decode_png(os.path.join(sheet_dir, name))
        check(img.shape == (side, side, 3) and img.std() > 0,
              (name, img.shape))
    check_figures(os.path.join(out, "figures"), ["wgan_loss_curve.png"])
    wgan_dir = os.path.join(out, "models", "wgan")
    names = sorted(os.listdir(wgan_dir))
    check(names == sorted(f"{m}_{t}.pth" for m in ("generator",
                                                     "discriminator")
                          for t in ("epoch_001", "final"))
          + ["snapshot_last.pth"], names)
    snap = torch.load(os.path.join(wgan_dir, names[-1]), weights_only=True)
    check(set(snap) == {"g", "c", "opt_g", "opt_c", "rng", "epoch",
                        "iters"} and snap["epoch"] == 1, sorted(snap))
    for name in names[:-1]:
        model = (Generator(LATENT, 3, FG, SIZE) if name.startswith("gen")
                 else Critic(3, FG, SIZE))
        model.load_state_dict(torch.load(os.path.join(wgan_dir, name),
                                         weights_only=True), strict=True)
    print(f"WGAN-GP run: history keys with {lengths}; {len(sheets)} sheets "
          f"of {side}x{side} and wgan_loss_curve.png decode; {names} load "
          "strictly")

    kernels.reset_launch_counts()
    stats = sample_main([
        "--model-path", os.path.join(wgan_dir, "generator_final.pth"),
        "--output-dir", os.path.join(out, "synthetic"),
        "--num-images", str(B), "--latent-dim", str(LATENT),
        "--feature-maps-g", str(FG), "--image-size", str(SIZE),
        "--batch-size", str(B), "--compute-dtype", "bf16"])
    torch.cuda.synchronize()
    chain = dict(kernels.LAUNCHES)
    check(stats["written"] == B and on_new_designs(chain, 5),
          (stats, chain))
    img = decode_png(os.path.join(out, "synthetic", f"synthetic_{B:05d}.png"))
    check(img.shape == (SIZE, SIZE, 3), img.shape)
    print(f"WGAN-GP -> sampler: {stats['written']} images from the trained "
          f"generator_final.pth, launches {chain}")
    return want + chain.get("convt4x4s2_fused", 0)


def wgan_models(dtype, seed: int = 0, capturable: bool = False):
    """Seeded full-width WGAN-GP G and critic (fg = fd = 64, 224 px) on the
    card and their Adam optimizers (betas (0.5, 0.9); ``capturable``: as
    the trainer builds them on the card)."""
    from xgan_torch.models.wgan import Critic, Generator
    from xgan_torch.train.common import adam
    dev = torch.device("cuda")
    g = Generator(LATENT, 3, FG, SIZE, dtype=dtype, device=dev,
                  generator=torch.Generator(dev).manual_seed(seed))
    c = Critic(3, FG, SIZE, dtype=dtype, device=dev,
               generator=torch.Generator(dev).manual_seed(seed + 1))
    return (g, c, adam(g.parameters(), 2e-4, 0.5, 0.9, capturable=capturable),
            adam(c.parameters(), 2e-4, 0.5, 0.9, capturable=capturable))


def phase_wgan_step_check(train_store):
    """One f32 WGAN-GP step at full width (B = 16, 2 critic updates, TF32
    off, deterministic cuDNN) with G's k4s2 forwards on the kernel and on
    the plain version, from the same weights, optimizer state and
    injected draws: the losses within 1e-4 * (1 + |ref|), the per-tensor
    gradient norms of G and the critic within 1e-3 relative; a second
    kernel run gives the run-to-run floor, and the plain version with its
    outputs perturbed by 1e-7 relative (f32 rounding) the floor that the
    step's own conditioning sets.

    The held step follows 3 warm-up steps (plain version, shared by all
    runs through a snapshot). At the first step Adam moves each weight by
    lr * g / (|g| + eps), about lr * sign(g), so a coordinate whose
    gradient is within rounding of zero moves by ±lr on either path, and
    through the two critic updates G's per-tensor gradient norms move by
    about the limit on rounding alone. The comparisons from the fresh
    weights are printed, not held."""
    import copy
    from xgan_torch import kernels
    from xgan_torch.data.pipeline import DeviceStore
    from xgan_torch.kernels.convt import convt4x4s2_fused_ref
    from xgan_torch.train.wgan import wgan_step
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    dev = torch.device("cuda")
    store = DeviceStore(train_store, dev)
    b, n = 16, 2
    g = torch.Generator(device=dev).manual_seed(13)
    idx = torch.randint(0, len(store), (b,), generator=g, device=dev)
    draws = {"flip": torch.rand(b, generator=g, device=dev) < 0.5,
             "noises": [torch.randn(b, LATENT, generator=g, device=dev)
                        for _ in range(n)],
             "alphas": [torch.rand(b, 1, 1, 1, generator=g, device=dev)
                        for _ in range(n)],
             "g_noise": torch.randn(b, LATENT, generator=g, device=dev)}
    nets = wgan_models(torch.float32)
    fresh = copy.deepcopy([m.state_dict() for m in nets])
    for _ in range(3):
        wgan_step(*nets, store.images,
                  torch.randint(0, len(store), (b,), generator=g, device=dev),
                  latent_dim=LATENT, critic_iters=n, lambda_gp=10.0,
                  convt=convt4x4s2_fused_ref, generator=g)
    warm = copy.deepcopy([m.state_dict() for m in nets])

    noise = torch.Generator(device=dev)

    def perturbed(*args, **kw):
        y = convt4x4s2_fused_ref(*args, **kw)
        return y * (1 + 1e-7 * torch.randn(y.shape, generator=noise,
                                           device=dev))

    def run(state, convt):
        for m, sd in zip(nets, copy.deepcopy(state)):
            m.load_state_dict(sd)
        kw = {} if convt is None else {"convt": convt}
        kernels.reset_launch_counts()
        losses = wgan_step(*nets, store.images, idx, latent_dim=LATENT,
                           critic_iters=n, lambda_gp=10.0, **draws, **kw)
        noise.manual_seed(0)
        check(kernels.LAUNCHES["convt4x4s2_fused"]
              == (5 * (n + 1) if convt is None else 0), dict(kernels.LAUNCHES))
        return losses, torch.stack([p.grad.norm() for p in
                                    [*nets[0].parameters(),
                                     *nets[1].parameters()]])

    def diffs(a, ref):
        (l_a, n_a), (l_r, n_r) = a, ref
        return (((l_a - l_r).abs() / (1 + l_r.abs())).max().item(),
                ((n_a - n_r).abs() / n_r).tolist())

    names = [f"G.{k}" for k, _ in nets[0].named_parameters()] \
        + [f"C.{k}" for k, _ in nets[1].named_parameters()]
    cold_plain = run(fresh, convt4x4s2_fused_ref)
    cold_l, cold_rel = diffs(run(fresh, None), cold_plain)
    cold_noise_l, cold_noise = diffs(run(fresh, perturbed), cold_plain)
    kern, plain, kern2 = (run(warm, None), run(warm, convt4x4s2_fused_ref),
                          run(warm, None))
    noise_l, noise_rel = diffs(run(warm, perturbed), plain)
    torch.backends.cudnn.deterministic = False
    l_err, rel = diffs(kern, plain)
    l_floor, rel_floor = diffs(kern2, kern)
    worst = sorted(zip(rel, names), reverse=True)[:3]
    cold_worst = max(zip(cold_rel, names))
    cold_noise_worst = max(zip(cold_noise, names))
    print(f"f32 WGAN-GP step (B={b}, {n} critic updates, after 3 warm-up "
          f"steps), kernel vs plain G forward: losses "
          f"{[round(v, 6) for v in kern[0].tolist()]}, max |diff| / (1 + "
          f"|ref|) {l_err:.3g} (tol 1e-4; kernel vs kernel {l_floor:.3g}); "
          f"G and critic gradient norms max relative diff {max(rel):.3g} "
          f"(tol 1e-3; kernel vs kernel {max(rel_floor):.3g}); worst "
          + ", ".join(f"{k} {r:.3g}" for r, k in worst)
          + f"; plain vs plain perturbed by 1e-7: losses {noise_l:.3g}, "
          f"gradient norms {max(noise_rel):.3g}. From the fresh weights "
          f"(not held): kernel vs plain losses {cold_l:.3g}, gradient norms "
          f"{cold_worst[0]:.3g} ({cold_worst[1]}); plain vs perturbed "
          f"losses {cold_noise_l:.3g}, gradient norms "
          f"{cold_noise_worst[0]:.3g} ({cold_noise_worst[1]})")
    check(l_err <= 1e-4, "f32 WGAN-GP step: kernel vs plain losses differ")
    check(max(rel) <= 1e-3, "f32 WGAN-GP step: gradient norms differ")


def wgan_step_flops(b: int, critic_iters: int) -> dict:
    """Model FLOPs of one WGAN-GP step at full width, from the layer
    shapes: F_G and F_C, one forward of G and of the critic (2 per
    multiply-add); the step as (n + 3) F_G (n + 1 forwards, one backward
    of ~2 F_G) plus (12 n + 2) F_C (per critic update: 3 forwards, the
    penalty's input gradient ~1, the backward of the real and fake passes
    ~2 each, of the penalty's forward and input-gradient graph ~2 + ~2;
    then G's pass through the critic, forward and input gradient)."""
    s0 = SIZE // 32
    f_g = 2 * b * LATENT * s0 * s0 * WGAN_WIDTHS[0] + sum(
        2 * b * (2 * h) ** 2 * cout * 4 * cin
        for h, cin, cout, _ in layer_shapes(WGAN_WIDTHS))
    widths = [3, FG, FG * 2, FG * 4, FG * 8]
    f_c = sum(2 * b * (SIZE // 2 ** (i + 1)) ** 2 * widths[i + 1] * 16
              * widths[i] for i in range(4))
    f_c += 2 * b * (SIZE // 16 - s0 + 1) ** 2 * s0 * s0 * widths[-1]
    n = critic_iters
    return {"G": f_g, "C": f_c,
            "step": (n + 3) * f_g + (12 * n + 2) * f_c,
            "convt_fwd": (n + 1) * sum(
                2 * b * (2 * h) ** 2 * cout * 4 * cin
                for h, cin, cout, _ in layer_shapes(WGAN_WIDTHS))}


def phase_wgan_profile(train_store, smi: str):
    """8 warm bf16 WGAN-GP steps at B = 64 with 5 critic updates (phase
    19's K = 1 run times the same step): ms per step, imgs/s; one
    profiled step: 30 ConvT kernel launches, the top
    device ops, the ConvT kernels' share, the idle share; the model FLOPs
    and the bound they give."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from xgan_torch import kernels
    from xgan_torch.data.pipeline import DeviceStore
    from xgan_torch.train.wgan import wgan_step
    dev = torch.device("cuda")
    store = DeviceStore(train_store, dev)
    g_net, c_net, opt_g, opt_c = wgan_models(torch.bfloat16, seed=14)
    gen = torch.Generator(dev).manual_seed(15)
    idx = torch.randint(0, len(store), (12, WGAN_B), generator=gen,
                        device=dev)

    def step(i):
        return wgan_step(g_net, c_net, opt_g, opt_c, store.images, idx[i],
                         latent_dim=LATENT, critic_iters=WGAN_CRITIC,
                         lambda_gp=10.0, dtype=torch.bfloat16, generator=gen)

    for i in range(3):
        step(i)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(3, 11):
        losses = step(i)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) / 8 * 1e3
    check(bool(torch.isfinite(losses).all()), losses)
    kernels.reset_launch_counts()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=True) as prof:
        step(11)
        torch.cuda.synchronize()
    # the wrapper's count, not the trace's: a trace can miss a kernel
    want = 5 * (WGAN_CRITIC + 1)
    check(on_new_designs(kernels.LAUNCHES, want), dict(kernels.LAUNCHES))
    events = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    ours = [e for e in events if "convt4x4s2" in e.name]
    busy_ms = sum(e.device_time for e in events) / 1e3
    ours_ms = sum(e.device_time for e in ours) / 1e3
    flops = wgan_step_flops(WGAN_B, WGAN_CRITIC)
    bound_ms = flops["step"] / BF16_PEAK_FLOPS * 1e3
    print(f"WGAN-GP train step (bf16, B={WGAN_B}, {WGAN_CRITIC} critic "
          f"updates, 224 px, fg = fd = 64): {step_ms:.3f} ms per step (mean "
          f"of 8 warm), {WGAN_B / step_ms * 1e3:.1f} imgs/s; profiled step: "
          f"{len(events)} kernels, {busy_ms:.3f} ms device time, {len(ours)} "
          f"convt4x4s2 kernels {ours_ms:.3f} ms (share "
          f"{ours_ms / busy_ms:.3f}); device idle share "
          f"~{1 - busy_ms / step_ms:.3f}; model FLOPs: G forward "
          f"{flops['G'] / 1e9:.1f} GFLOP, critic forward "
          f"{flops['C'] / 1e9:.1f} GFLOP, step {flops['step'] / 1e12:.3f} "
          f"TFLOP (ConvT kernel forwards {flops['convt_fwd'] / 1e12:.3f}), "
          f"bound {bound_ms:.3f} ms at {BF16_PEAK_FLOPS / 1e12:.0f} TFLOP/s, "
          f"{flops['step'] / step_ms / 1e9:.1f} TFLOP/s achieved; {smi}")
    top = sorted(prof.key_averages(), key=lambda e: -e.self_device_time_total)
    for e in top[:14]:
        if e.self_device_time_total > 0:
            print(f"  {e.self_device_time_total / 1e3:9.3f} ms  "
                  f"x{e.count:<4d} {e.key[:90]}")
    # the convolutions by input shapes: which of the critic's passes
    # (forward, backward, the penalty's double backward) holds the time
    convs = sorted((e for e in prof.key_averages(group_by_input_shape=True)
                    if e.key in ("aten::cudnn_convolution",
                                 "aten::convolution_backward",
                                 "aten::_convolution_double_backward")),
                   key=lambda e: -e.device_time_total)
    print("WGAN-GP step, convolutions by input shapes (device ms, calls):")
    for e in convs[:10]:
        print(f"  {e.device_time_total / 1e3:9.3f} ms  x{e.count:<4d} "
              f"{e.key} {[s for s in e.input_shapes if s][:3]}")


CGAN_B, CGAN_FM, CGAN_STEPS = 32, 32, 4  # src/train_cgan.py defaults
CGAN_HISTORY_KEYS = GAN_HISTORY_KEYS | {"perceptual_losses",
                                        "feature_matching_losses"}


def phase_cgan_train(tmp: str, root: str):
    """CGAN training through its CLI at full width (224 px, fg = fd = 32,
    latent 100, B = 32, bf16, random VGG features) on the RSNA tree, 1
    epoch cut to 4 steps, then the CGAN sampler CLI on its
    ``generator_final.pth``. The path runs no hand-written kernel: both
    runs must leave every launch count at 0."""
    from xgan_torch import kernels
    from xgan_torch.cli.generate_synthetic_cgan import main as sample_main
    from xgan_torch.cli.train_cgan import main as cgan_main
    from xgan_torch.models.cgan import Discriminator, Generator
    from xgan_torch.native.png import decode_png
    out = os.path.join(tmp, "cgan")
    argv = ["--data-dir", root, "--model-dir", os.path.join(out, "models"),
            "--output-dir", os.path.join(out, "results"),
            "--results-dir", os.path.join(out, "metrics"),
            "--figures-dir", os.path.join(out, "figures"),
            "--cache-dir", os.path.join(tmp, "cache"), "--workers", "8",
            "--image-size", str(SIZE), "--feature-maps-g", str(CGAN_FM),
            "--feature-maps-d", str(CGAN_FM), "--latent-dim", str(LATENT),
            "--batch-size", str(CGAN_B), "--epochs", "1",
            "--limit-batches", str(CGAN_STEPS), "--compute-dtype", "bf16"]
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    history = cgan_main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    sheet_dir = os.path.join(out, "results", "cgan_images")
    sheets = sorted(os.listdir(sheet_dir))
    print(f"CGAN run: {wall:.1f} s wall, {CGAN_STEPS} train steps, "
          f"{len(sheets)} sample sheets, launches {dict(kernels.LAUNCHES)}; "
          f"last metrics G {history['G_losses_iter'][-1]:.4f} D "
          f"{history['D_losses_iter'][-1]:.4f} perceptual "
          f"{history['perceptual_losses'][-1]:.4f} fm "
          f"{history['feature_matching_losses'][-1]:.4f}")
    check(sum(kernels.LAUNCHES.values()) == 0, dict(kernels.LAUNCHES))
    with open(os.path.join(out, "metrics", "cgan_training_history.json")) \
            as f:
        saved = json.load(f)
    check(set(saved) == CGAN_HISTORY_KEYS, sorted(saved))
    for key, series in saved.items():
        check(len(series) == (CGAN_STEPS if key.endswith("_iter") else 1),
              (key, len(series)))
        check(all(math.isfinite(v) for v in series), (key, series))
    check(sheets == ["fake_samples_epoch_001_iter_000000.png",
                     f"fake_samples_epoch_001_iter_{CGAN_STEPS - 1:06d}.png"],
          sheets)
    shape = (4 * (SIZE + 2) + 2, 8 * (SIZE + 2) + 2, 3)  # 32 images, 8 a row
    for name in sheets:
        img = decode_png(os.path.join(sheet_dir, name))
        check(img.shape == shape and img.std() > 0, (name, img.shape))
    check_figures(os.path.join(out, "figures"), ["cgan_loss_curve.png"])
    cgan_dir = os.path.join(out, "models", "cgan")
    names = sorted(os.listdir(cgan_dir))
    check(names == sorted(f"{m}_{t}.pth" for m in ("generator",
                                                     "discriminator")
                          for t in ("epoch_001", "final"))
          + ["snapshot_last.pth"], names)
    snap = torch.load(os.path.join(cgan_dir, names[-1]), weights_only=True)
    check(set(snap) == {"g", "d", "opt_g", "opt_d", "rng", "epoch",
                        "iters"} and snap["epoch"] == 1, sorted(snap))
    for name in names[:-1]:
        model = (Generator(LATENT, 2, 3, CGAN_FM, SIZE)
                 if name.startswith("gen")
                 else Discriminator(2, 3, CGAN_FM, SIZE))
        model.load_state_dict(torch.load(os.path.join(cgan_dir, name),
                                         weights_only=True), strict=True)
    print(f"CGAN run: history keys with {CGAN_STEPS} / 1 finite entries; "
          f"{len(sheets)} sheets of {shape[1]}x{shape[0]} and "
          f"cgan_loss_curve.png decode; {names} load strictly")

    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    stats = sample_main([
        "--model-path", os.path.join(cgan_dir, "generator_final.pth"),
        "--output-dir", os.path.join(out, "synthetic"),
        "--num-images", str(B), "--latent-dim", str(LATENT),
        "--feature-maps-g", str(CGAN_FM), "--image-size", str(SIZE),
        "--batch-size", str(B), "--compute-dtype", "bf16"])
    torch.cuda.synchronize()
    check(stats["written"] == B and sum(kernels.LAUNCHES.values()) == 0,
          (stats, dict(kernels.LAUNCHES)))
    pngs = sorted(os.listdir(os.path.join(out, "synthetic")))
    check(len(pngs) == B, len(pngs))
    for name in pngs:
        img = decode_png(os.path.join(out, "synthetic", name))
        check(img.shape == (SIZE, SIZE, 3), (name, img.shape))
    print(f"CGAN -> sampler: {stats['written']} PNGs from the trained "
          f"generator_final.pth decode, {time.perf_counter() - t0:.2f} s "
          f"wall (one cold run)")


def cgan_models(dev, dtype, seed: int = 0, capturable: bool = False):
    """Seeded full-width CGAN G and D (fg = fd = 32, 224 px), random VGG16
    features, on ``dev``, and the Adam optimizers of G and D
    (``capturable``: as the trainer builds them on the card)."""
    from xgan_torch.models.cgan import Discriminator, Generator
    from xgan_torch.models.vgg import VGG16Features
    from xgan_torch.train.common import adam
    gen = torch.Generator().manual_seed(seed)
    g = Generator(LATENT, 2, 3, CGAN_FM, SIZE, dtype=dtype, generator=gen)
    d = Discriminator(2, 3, CGAN_FM, SIZE, dtype=dtype, generator=gen)
    vgg = VGG16Features(dtype=dtype, generator=gen)
    g, d, vgg = g.to(dev), d.to(dev), vgg.to(dev)
    return (g, d, vgg,
            adam(g.parameters(), 2e-4, 0.5, capturable=capturable),
            adam(d.parameters(), 2e-4, 0.5, capturable=capturable))


def pre_bn_biases():
    """The CGAN parameters right before a train-mode BN, as ``G.<name>``
    and ``D.<name>``: their gradient is 0 in exact arithmetic, so its norm
    is rounding noise."""
    from xgan_torch.models.cgan import D_PRE_BN_BIASES, G_PRE_BN_BIASES
    return ({f"G.{k}" for k in G_PRE_BN_BIASES}
            | {f"D.{k}" for k in D_PRE_BN_BIASES})


@contextlib.contextmanager
def noisy_convs(rel_rms: float, seed: int):
    """Every ``F.conv2d`` output (G's, D's and VGG16's convolutions) plus
    Gaussian noise of ``rel_rms`` times the output's rms: a stand-in for
    another f32 implementation's rounding, which is absolute in the
    size of the summands, so it also reaches the near-zero outputs whose
    ReLU and max-pool decisions it can flip."""
    import torch.nn.functional as F
    conv, gen = F.conv2d, torch.Generator().manual_seed(seed)

    def noisy(*args, **kwargs):
        y = conv(*args, **kwargs)
        scale = rel_rms * y.detach().square().mean().sqrt()
        return y + scale * torch.randn(y.shape, generator=gen).to(y)

    F.conv2d = noisy
    try:
        yield
    finally:
        F.conv2d = conv


CGAN_FLOOR_RMS = 1e-6


def phase_cgan_step_check(train_store, grad_accum: int = 1):
    """One f32 CGAN step at full width (B = 16, TF32 off, deterministic
    cuDNN; ``grad_accum`` microbatches, the warm-up steps' too) on the
    card against the same step on the CPU, from the same
    weights, Adam states and injected draws, after 3 warm-up steps on the
    card shared by both sides through a snapshot: the 7 metrics within
    1e-4 * (1 + |ref|); each tensor's gradient norm within 1e-3 relative
    plus twice its floor, the largest move of that norm when the CPU step
    runs against itself with :func:`noisy_convs` (two draws). The biases
    right before a BN (:func:`pre_bn_biases`) are printed, not held: their
    gradient is 0 in exact arithmetic.

    Why a floor: the step's gradient is discontinuous in its forward
    values (ReLU, max-pool and LeakyReLU decisions), and at 224 px some
    outputs lie within rounding of each kink, so two correct f32 runs can
    part by more than 1e-3 on some of G's tensors; the floor says on which
    and by how much, and a device bug moves a norm by far more. The noise
    level is that of the card's VGG16 features against the CPU's, printed
    beside it.

    The control: the same step on the card with TF32 on must fall outside
    these limits, on the metrics or on some held norm, or the check could
    not tell a lower precision from f32."""
    import copy
    from xgan_torch.train.cgan import cgan_step
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    cpu, dev = torch.device("cpu"), torch.device("cuda")
    images = torch.from_numpy(np.array(train_store.images))
    labels = torch.from_numpy(np.asarray(train_store.labels, np.int64))
    b = 16
    gen = torch.Generator().manual_seed(21)
    idx = torch.randint(0, len(labels), (b,), generator=gen)
    draws = {"flip": torch.rand(b, generator=gen) < 0.5,
             "noise": torch.randn(b, LATENT, generator=gen),
             "fake_labels": torch.randint(0, 2, (b,), generator=gen),
             "real_targets": 0.9 - 0.1 * torch.rand(b, generator=gen),
             "fake_targets": 0.1 + 0.1 * torch.rand(b, generator=gen)}
    on_card = (images.to(dev), labels.to(dev))
    nets = cgan_models(dev, torch.float32, seed=22)
    warm_gen = torch.Generator(dev).manual_seed(23)
    for i in range(3):
        cgan_step(*nets, *on_card,
                  torch.randint(0, len(labels), (b,), generator=warm_gen,
                                device=dev), 0, latent_dim=LATENT,
                  generator=warm_gen, grad_accum=grad_accum)
    warm = copy.deepcopy([m.state_dict() for m in nets[:2] + nets[3:]])

    def run(state, device, floor_seed=None):
        g, d, vgg, opt_g, opt_d = cgan_models(device, torch.float32,
                                              seed=22)
        for m, sd in zip((g, d, opt_g, opt_d), copy.deepcopy(state)):
            m.load_state_dict(sd)
        store = on_card if device.type == "cuda" else (images, labels)
        with (noisy_convs(CGAN_FLOOR_RMS, floor_seed)
              if floor_seed is not None else contextlib.nullcontext()):
            m = cgan_step(g, d, vgg, opt_g, opt_d, *store, idx.to(device),
                          0, latent_dim=LATENT, grad_accum=grad_accum,
                          **{k: v.to(device) for k, v in draws.items()})
        params = [(f"G.{k}", p) for k, p in g.named_parameters()] \
            + [(f"D.{k}", p) for k, p in d.named_parameters()]
        return m.cpu(), {k: p.grad.norm().item() for k, p in params}

    noisy = pre_bn_biases()

    def diffs(a, ref):
        (m_a, n_a), (m_r, n_r) = a, ref
        return (((m_a - m_r).abs() / (1 + m_r.abs())).max().item(),
                {k: abs(n_a[k] - n_r[k]) / n_r[k] for k in n_r
                 if k not in noisy})

    def worst(rel):
        k = max(rel, key=rel.get)
        return f"{rel[k]:.3g} ({k})"

    x = images[idx].float() / 127.5 - 1
    with torch.no_grad():
        vgg_err = [((a.cpu() - r).abs().max() / r.square().mean().sqrt())
                   .item() for a, r in zip(nets[2](x.to(dev)), cgan_models(
                       cpu, torch.float32, seed=22)[2](x))]
    t0 = time.perf_counter()
    ref = run(warm, cpu)
    card, card2 = run(warm, dev), run(warm, dev)
    floors = [diffs(run(warm, cpu, floor_seed=s), ref) for s in (1, 2)]
    cpu_s = time.perf_counter() - t0
    # the control: the card step at a lower precision (TF32 convolutions
    # and matmuls, 10 mantissa bits) must fail the same limits
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    try:
        card_tf32 = run(warm, dev)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = False
    l_err, rel = diffs(card, ref)
    l_k, rel_k = diffs(card2, card)
    floor = {k: max(f[1][k] for f in floors) for k in rel}
    limit = {k: 1e-3 + 2 * floor[k] for k in rel}
    ratio = {k: rel[k] / limit[k] for k in rel}
    over = sorted(k for k in rel if floor[k] > 1e-3)
    print(f"f32 CGAN step (B={b}, A={grad_accum}, 224 px, fg = fd = 32, "
          f"after 3 warm-up steps), card vs CPU: metrics "
          f"{[round(v, 6) for v in card[0].tolist()]}, max |diff| / (1 + "
          f"|ref|) {l_err:.3g} (tol 1e-4; card vs card {l_k:.3g}; floor "
          f"{max(f[0] for f in floors):.3g}); gradient norms, largest "
          f"relative diff {worst(rel)}, largest share of its limit "
          f"{worst(ratio)} (limit 1e-3 + 2 x floor; card vs card "
          f"{max(rel_k.values()):.3g}); floor (CPU vs CPU, conv outputs + "
          f"{CGAN_FLOOR_RMS:g} rms noise, 2 draws; card vs CPU VGG16 "
          f"features max |diff| / rms {[f'{e:.2g}' for e in vgg_err]}): "
          f"largest {worst(floor)}, "
          f"above 1e-3 on {len(over)} of {len(rel)} tensors {over}; the "
          f"pre-BN biases, not held: norms {max(ref[1][k] for k in noisy):.3g}"
          f" at most, against {min(ref[1][k] for k in rel):.3g} for the "
          f"smallest held tensor; {cpu_s:.1f} s for the 6 steps")
    tf_l, tf_rel = diffs(card_tf32, ref)
    tf_ratio = {k: tf_rel[k] / limit[k] for k in rel}
    tf_over = sorted(k for k in rel if tf_ratio[k] > 1)
    print(f"control, the same step on the card with TF32 on, against the "
          f"same limits: metrics {tf_l:.3g} (tol 1e-4), gradient norms "
          f"largest relative diff {worst(tf_rel)}, largest share of its "
          f"limit {worst(tf_ratio)}, over the limit on {len(tf_over)} of "
          f"{len(rel)} tensors {tf_over}")
    check(l_err <= 1e-4, "f32 CGAN step: card vs CPU metrics differ")
    check(all(rel[k] <= limit[k] for k in rel),
          ("f32 CGAN step: gradient norms differ",
           {k: (rel[k], limit[k]) for k in rel if rel[k] > limit[k]}))
    check(tf_l > 1e-4 or tf_over,
          "f32 CGAN step check: a TF32 step on the card passes it too")


def cgan_step_flops(b: int) -> dict:
    """Model FLOPs of one CGAN step at full width (224 px, fg = fd = 32),
    from the layer shapes (2 per multiply-add): F_G, F_D and F_V, one
    forward of G, D and the three VGG16 blocks. The step with the gate
    open: G one forward and its backward (~2 F_G); D on real and fake,
    their backward (weights and inner inputs, ~2 F_D each), D on the fake
    with its input gradient (~2 F_D) and on the real (1 F_D): 9 F_D; VGG
    on the fake and the real and the fake's input gradient: 3 F_V. A
    closed gate skips D's backward on real and fake: 5 F_D."""
    s0, nf = SIZE // 32, CGAN_FM
    widths = [nf * 8, nf * 4, nf * 2, nf, nf // 2, 3]
    f_g = 2 * b * LATENT * widths[0] * s0 * s0 + sum(
        2 * b * (s0 * 2 ** (i + 1)) ** 2 * widths[i + 1] * widths[i] * 9
        for i in range(5))
    d_widths = [3, nf // 2, nf, nf * 2, nf * 4, nf * 8]
    f_d = sum(2 * b * (SIZE // 2 ** (i + 1)) ** 2 * d_widths[i + 1] * 16
              * d_widths[i] for i in range(5)) + 2 * b * s0 * s0 * d_widths[-1]
    f_v, side, cin = 0, SIZE, 3
    for cout in (64, 64, "M", 128, 128, "M", 256, 256, 256):
        if cout == "M":
            side //= 2
            continue
        f_v += 2 * b * side * side * cout * cin * 9
        cin = cout
    return {"G": f_g, "D": f_d, "VGG": f_v,
            "step": 3 * f_g + 9 * f_d + 3 * f_v,
            "step_closed": 3 * f_g + 5 * f_d + 3 * f_v}


def phase_cgan_profile(train_store, smi: str):
    """Warm bf16 CGAN steps at B = 32 (fg = fd = 32, random VGG16
    features, the trainer's capturable Adam) in the three forms of the
    adaptive gate, a select on the device in each (D's backward and Adam
    step always run; a closed gate selects D and its Adam state back):
    epoch 0 (held open by the epoch), and epoch 5, open and closed. For
    each form: ms per step over 20 warm steps, imgs/s and D's Adam steps
    that stood (20 open, 0 closed); one profiled step: kernels, device
    ms, the device idle share and the longest host read of a device value
    (none is expected). For epoch 0 also the top device ops and the model
    FLOPs with the bound they give.

    The epoch-5 forms fix the gate through D's projection: D's last BN
    with scale 0 and shift 1 makes the last LeakyReLU map all ones,
    whatever G draws; every real label 0, every fake label 1, and
    ``label_emb`` rows of -c and +c (open: D(x) ~ 0, D(G(z)) ~ 1) or +c
    and -c (closed), with c = 500 / the map's size, put the logits near
    -+500. D's Adam (lr 2e-4, sign-like first steps) moves them by about
    2e-4 * 12,544 ~ 2.5 a step through ``label_emb``, as much through the
    last conv: ~120 in 24 steps, so the gate stays as set."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from xgan_torch.data.pipeline import DeviceStore
    from xgan_torch.models.cgan import SEQ_D_BN
    from xgan_torch.train.cgan import GATE_EPOCHS, cgan_step
    dev = torch.device("cuda")
    store = DeviceStore(train_store, dev)
    gen = torch.Generator(dev).manual_seed(25)
    idx = torch.randint(0, len(store), (24, CGAN_B), generator=gen,
                        device=dev)

    def run(epoch, closed=None):
        nets = cgan_models(dev, torch.bfloat16, seed=24, capturable=True)
        d, opt_d = nets[1], nets[4]
        labels, draws = store.labels, {}
        if closed is not None:
            emb, bn = d.label_emb.weight, d.main[SEQ_D_BN[-1]]
            c = 500.0 / emb.shape[1] * (1 if closed else -1)
            with torch.no_grad():
                emb[0], emb[1] = c, -c
                bn.weight.zero_()
                bn.bias.fill_(1.0)
            labels = torch.zeros_like(store.labels)
            draws["fake_labels"] = torch.ones(CGAN_B, dtype=torch.int64,
                                              device=dev)

        def step(i):
            return cgan_step(*nets, store.images, labels, idx[i], epoch,
                             latent_dim=LATENT, dtype=torch.bfloat16,
                             generator=gen, **draws)

        def d_updates():
            state = opt_d.state.get(d.label_emb.weight)
            return int(state["step"]) if state else 0

        for i in range(3):
            step(i)
        torch.cuda.synchronize()
        before = d_updates()
        t0 = time.perf_counter()
        for i in range(3, 23):
            m = step(i)
        torch.cuda.synchronize()
        step_ms = (time.perf_counter() - t0) / 20 * 1e3
        updates = d_updates() - before
        check(bool(torch.isfinite(m).all()), m)
        check(updates == (0 if closed else 20), (epoch, closed, updates))
        if closed is not None:  # D(x), D(G(z)) of the last timed step
            d_x, d_g_z1 = m[2].item(), m[3].item()
            check((d_x >= 0.8 and d_g_z1 <= 0.2) == closed,
                  (closed, d_x, d_g_z1))
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            step(23)
            torch.cuda.synchronize()
        events = [e for e in prof.events()
                  if e.device_type == DeviceType.CUDA]
        busy_ms = sum(e.device_time for e in events) / 1e3
        wait_ms = max((e.cpu_time_total for e in prof.events()
                       if e.name == "aten::_local_scalar_dense"),
                      default=0) / 1e3
        print(f"CGAN train step (bf16, B={CGAN_B}, 224 px, fg = fd = "
              f"{CGAN_FM}, random VGG16), epoch {epoch}, gate "
              f"{'open' if not closed else 'closed'}"
              f" (the device select)"
              f": {step_ms:.3f} ms per step (mean of 20 warm), "
              f"{CGAN_B / step_ms * 1e3:.1f} imgs/s, {updates} D updates; "
              f"profiled step: {len(events)} kernels, {busy_ms:.3f} ms "
              f"device time, device idle share ~{1 - busy_ms / step_ms:.3f}"
              f", longest host read of a device value {wait_ms:.3f} ms; "
              f"{smi}")
        return step_ms, prof

    step_ms, prof = run(0)
    flops = cgan_step_flops(CGAN_B)
    bound_ms = flops["step"] / BF16_PEAK_FLOPS * 1e3
    print(f"CGAN step model FLOPs per image forward: G "
          f"{flops['G'] / CGAN_B / 1e9:.3f} GFLOP, D "
          f"{flops['D'] / CGAN_B / 1e9:.3f}, VGG16 blocks 1-3 "
          f"{flops['VGG'] / CGAN_B / 1e9:.3f}; step (gate open) "
          f"{flops['step'] / 1e12:.3f} TFLOP (VGG {3 * flops['VGG'] / 1e12:.3f}"
          f"), bound {bound_ms:.3f} ms at {BF16_PEAK_FLOPS / 1e12:.0f} "
          f"TFLOP/s, {flops['step'] / step_ms / 1e9:.1f} TFLOP/s achieved "
          f"at epoch 0; gate closed {flops['step_closed'] / 1e12:.3f} TFLOP,"
          f" bound {flops['step_closed'] / BF16_PEAK_FLOPS * 1e3:.3f} ms")
    top = sorted(prof.key_averages(), key=lambda e: -e.self_device_time_total)
    for e in top[:14]:
        if e.self_device_time_total > 0:
            print(f"  {e.self_device_time_total / 1e3:9.3f} ms  "
                  f"x{e.count:<4d} {e.key[:90]}")
    # the three forms, then the first two again: the host's pace drifts
    for closed in (False, True):
        run(GATE_EPOCHS, closed)
    run(0)
    run(GATE_EPOCHS, False)


LOOP_A, LOOP_K = 4, 4  # --grad-accum (microbatches of 32), --steps-per-call
LOOP_TOL = dict(rtol=2e-4, atol=2e-5)  # tests/test_multistep.py:17


def phase_loop_grad_accum(train_store, smi: str) -> int:
    """``--grad-accum``: the bf16 step at B = 128 as A = 1 and A = 4
    (microbatch 32), each the mean of 20 warm steps, its ConvT launches
    (5 and 40) and its peak memory; then one f32 A = 2 step (B = 16, TF32
    off, deterministic cuDNN) through the kernel against the same step
    through the plain version, after 3 shared warm-up steps as the
    WGAN-GP check holds its step: metrics within 1e-4 (1 + |ref|), each
    of G's gradient norms within 1e-3 relative plus twice the floor that
    the kernel's own rounding sets (as the CGAN check), and the same
    kernel step with TF32 on must exceed those norm limits (the control).
    Returns the launches of the counted steps."""
    from xgan_torch import kernels
    from xgan_torch.data.pipeline import DeviceStore
    from xgan_torch.train.gan import dcgan_step
    dev = torch.device("cuda")
    store = DeviceStore(train_store, dev)
    launched = 0
    for accum in (1, LOOP_A):
        g_net, d_net, opt_g, opt_d = gan_models(torch.bfloat16, seed=20)
        gen = torch.Generator(dev).manual_seed(21)
        idx = torch.randint(0, len(store), (24, GAN_B), generator=gen,
                            device=dev)

        def step(i):
            return dcgan_step(g_net, d_net, opt_g, opt_d, store.images,
                              idx[i], latent_dim=LATENT,
                              dtype=torch.bfloat16, generator=gen,
                              grad_accum=accum)

        for i in range(3):
            step(i)
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        torch.cuda.reset_peak_memory_stats()
        before = torch.cuda.memory_allocated()
        step(3)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
        launches = dict(kernels.LAUNCHES)
        launched += launches.get("convt4x4s2_fused", 0)
        want = 10 * accum if accum > 1 else 5  # 2 * A * 5 with microbatches
        check(on_new_designs(launches, want)
              and launches.get("convt4x4s2_fused", 0) == want,
              (accum, launches))
        t0 = time.perf_counter()
        for i in range(4, 24):
            m = step(i)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) / 20 * 1e3
        check(bool(torch.isfinite(m).all()), m)
        print(f"grad-accum A={accum} (bf16, B={GAN_B}, microbatch "
              f"{GAN_B // accum}, 224 px, fg = fd = 64): {ms:.3f} ms per "
              f"step (mean of 20 warm), {GAN_B / ms * 1e3:.1f} imgs/s; "
              f"ConvT launches per step {launches}; peak memory of a step "
              f"{peak / 2**30:.3f} GiB ({(peak - before) / 2**30:.3f} GiB "
              f"above the {before / 2**30:.3f} GiB held before it) [{smi}]")
        del g_net, d_net, opt_g, opt_d
        torch.cuda.empty_cache()

    # f32 A = 2, held by hold_f32_kernel_step
    import copy
    from xgan_torch.kernels.convt import convt4x4s2_fused_ref
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    b = 16
    conv_rel = convt_rel_rms(b)
    g = torch.Generator(device=dev).manual_seed(24)
    idx = torch.randint(0, len(store), (b,), generator=g, device=dev)
    draws = {"flip": torch.rand(b, generator=g, device=dev) < 0.5,
             "noise": torch.randn(b, LATENT, generator=g, device=dev)}
    nets = gan_models(torch.float32, seed=25)
    fresh = copy.deepcopy([m.state_dict() for m in nets])
    for _ in range(3):
        dcgan_step(*nets, store.images,
                   torch.randint(0, len(store), (b,), generator=g,
                                 device=dev),
                   latent_dim=LATENT, convt=convt4x4s2_fused_ref,
                   generator=g, grad_accum=2)
    warm = copy.deepcopy([m.state_dict() for m in nets])

    def step(convt):
        kw = {} if convt is None else {"convt": convt}
        return dcgan_step(*nets, store.images, idx, latent_dim=LATENT,
                          grad_accum=2, **draws, **kw)

    hold_f32_kernel_step(f"A=2 GAN step (B={b})", nets, fresh, warm, step,
                         20, lambda: list(nets[0].parameters()), conv_rel)
    return launched


def convt_rel_rms(b: int, widths=None) -> float:
    """The kernel's relative rms error against its plain version at the
    five f32 layers of a GAN train forward (act none) at batch ``b``."""
    from xgan_torch.kernels.convt import (convt4x4s2_fused,
                                          convt4x4s2_fused_ref,
                                          pack_convt_weight)
    dev = torch.device("cuda")
    rel = 0.0
    for x, w, _ in gan_layer_inputs(b, torch.float32, seed=26,
                                    widths=widths):
        wp = pack_convt_weight(w, x.dtype)
        ones = torch.ones(w.shape[1], device=dev)
        zeros = torch.zeros(w.shape[1], device=dev)
        got = convt4x4s2_fused(x, wp, ones, zeros, act="none")
        want = convt4x4s2_fused_ref(x, wp, ones, zeros, act="none")
        rel = max(rel, ((got - want).square().mean().sqrt()
                        / want.square().mean().sqrt()).item())
    return rel


def hold_f32_kernel_step(label: str, nets, fresh, warm, step, launches: int,
                         params, conv_rel: float) -> None:
    """One f32 GAN step (TF32 off, deterministic cuDNN) through the kernel
    against the same step through the plain version, from the state
    ``warm`` (after 3 shared warm-up steps, as phase_wgan_step_check holds
    its step): metrics within 1e-4 (1 + |ref|), each gradient norm of
    ``params()`` within 1e-3 relative plus twice the floor that the
    kernel's own rounding sets (as the CGAN check): the plain version with
    each ConvT output perturbed by noise of the kernel's measured relative
    error ``conv_rel``, two draws. The same kernel step with TF32 on must
    exceed those norm limits (the control). Microbatches' gradients partly
    cancel in BN scales' sums, so rounding alone moves their norms near
    the plain 1e-3 (from the fresh reference init ``fresh``, past it:
    printed, not held).

    ``nets``: the modules and optimizers that ``fresh`` and ``warm`` hold;
    ``step(convt)`` runs the step on fixed inputs and draws (``convt``
    None: the kernel) and returns its metrics; ``launches``: the ConvT
    launches of a kernel step."""
    import copy
    from xgan_torch import kernels
    from xgan_torch.kernels.convt import convt4x4s2_fused_ref
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    noise = torch.Generator(device=dev)

    def perturbed(*args, **kw):
        y = convt4x4s2_fused_ref(*args, **kw)
        return y * (1 + conv_rel * torch.randn(y.shape, generator=noise,
                                               device=dev))

    def run(state, convt, seed=0):
        for m, sd in zip(nets, copy.deepcopy(state)):
            m.load_state_dict(sd)
        kernels.reset_launch_counts()
        noise.manual_seed(seed)
        m = step(convt)
        check(kernels.LAUNCHES["convt4x4s2_fused"]
              == (launches if convt is None else 0), dict(kernels.LAUNCHES))
        return m, torch.stack([p.grad.norm() for p in params()])

    def diffs(a, ref):
        (m_a, n_a), (m_r, n_r) = a, ref
        return (((m_a - m_r).abs() / (1 + m_r.abs())).max().item(),
                ((n_a - n_r).abs() / n_r))

    try:
        held = params()
        names = [f"{type(m).__name__}.{k}" for m in nets
                 if isinstance(m, torch.nn.Module)
                 for k, p in m.named_parameters()
                 if any(p is q for q in held)]
        cold_plain = run(fresh, convt4x4s2_fused_ref)
        cold_m, cold_rel = diffs(run(fresh, None), cold_plain)
        kern, plain, kern2 = (run(warm, None), run(warm, convt4x4s2_fused_ref),
                              run(warm, None))
        floors = [diffs(run(warm, perturbed, seed), plain) for seed in (1, 2)]
        # the control: the kernel step with TF32 convolutions and matmuls
        # (10 mantissa bits) must fail the norm limits below
        torch.backends.cuda.matmul.allow_tf32 = True
        torch.backends.cudnn.allow_tf32 = True
        kern_tf32 = run(warm, None)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cudnn.deterministic = False
    m_err, rel = diffs(kern, plain)
    m_floor, rel_floor = diffs(kern2, kern)
    floor = torch.maximum(floors[0][1], floors[1][1])
    limit = 1e-3 + 2 * floor
    ratio = (rel / limit).max().item()
    worst = sorted(zip(rel.tolist(), floor.tolist(), names),
                   reverse=True)[:3]
    print(f"f32 {label}, after 3 warm-up steps, kernel vs plain G "
          f"forward: metrics max |diff| / (1 + |ref|) {m_err:.3g} (tol "
          f"1e-4; kernel vs kernel {m_floor:.3g}); gradient norms max "
          f"relative diff {rel.max().item():.3g} (kernel vs kernel "
          f"{rel_floor.max().item():.3g}); the kernel's relative rms error "
          f"{conv_rel:.3g}, the plain version perturbed by it: metrics "
          f"{max(f[0] for f in floors):.3g}, norms up to "
          f"{floor.max().item():.3g}; worst (diff, floor) "
          + ", ".join(f"{k} ({r:.3g}, {f:.3g})" for r, f, k in worst)
          + f"; held at 1e-3 + 2 floor: {ratio:.3f} of the limit. From the "
          f"fresh weights (not held): metrics {cold_m:.3g}, gradient norms "
          f"{cold_rel.max().item():.3g} "
          f"({names[int(cold_rel.argmax())]})")
    tf_m, tf_rel = diffs(kern_tf32, plain)
    tf_ratio = tf_rel / limit
    print(f"control, the kernel step with TF32 on, against the same "
          f"limits: metrics {tf_m:.3g} (tol 1e-4), gradient norms max "
          f"relative diff {tf_rel.max().item():.3g}, "
          f"{tf_ratio.max().item():.3f} of the limit "
          f"({names[int(tf_ratio.argmax())]}), over it on "
          f"{int((tf_ratio > 1).sum())} of {len(names)} tensors")
    check(m_err <= 1e-4, f"f32 {label}: kernel vs plain metrics differ")
    check(ratio <= 1.0, f"f32 {label}: gradient norms differ")
    check(tf_ratio.max().item() > 1.0,
          f"f32 {label} check: a TF32 step passes its norm limits too")


def idle_share(events, steps: int, step_ms: float) -> tuple[float, int, int]:
    """(device ms per step, kernels, ConvT kernels) of the profiler
    ``events`` of ``steps`` steps; the idle share is 1 - that /
    ``step_ms``."""
    from torch.autograd import DeviceType
    events = [e for e in events if e.device_type == DeviceType.CUDA]
    busy = sum(e.device_time for e in events) / 1e3 / steps
    return busy, len(events), sum("convt4x4s2" in e.name for e in events)


# (K, capturable Adam) of each run of phase_loop_steps_per_call: the
# trainer's capturable Adam at K = 1 and K; then K = 1 with the default
# Adam, for what the device-side update costs an eager step
# (K, capturable Adam): a process each (C6)
STEPS_PER_CALL_RUNS = ((1, True), (LOOP_K, True))


def phase_loop_steps_per_call(train_store, smi: str, run: int) -> list:
    """``--steps-per-call``, run ``STEPS_PER_CALL_RUNS[run]`` (run 0 first
    holds :func:`hold_k_replay` of the DCGAN step, EMA on): bf16 at
    B = 128, ms per step and, from one profiled window, the device idle
    share; for K > 1 the dispatcher's ConvT count per replay (5 a step)
    against a profiler trace of one replay. One run a process, so that
    its window is the first of its process (C6, ROADMAP.md). Returns
    [the launches of the timed steps, ms per step]."""
    from torch.autograd import DeviceType
    from xgan_torch import kernels
    from xgan_torch.data.pipeline import DeviceStore
    from xgan_torch.train.ema import ema_update, init_ema
    from xgan_torch.train.gan import dcgan_step
    dev = torch.device("cuda")
    store = DeviceStore(train_store, dev)

    def setup(k, dtype, b, steps, seed, capturable=True):
        g_net, d_net, opt_g, opt_d = gan_models(dtype, seed=seed,
                                                capturable=capturable)
        ema = init_ema(g_net)
        gen = torch.Generator(dev).manual_seed(seed + 2)
        idx = torch.randint(0, len(store), (steps, b), device=dev,
                            generator=torch.Generator(dev).manual_seed(
                                seed + 3))

        def step(i):
            m = dcgan_step(g_net, d_net, opt_g, opt_d, store.images, i,
                           latent_dim=LATENT, dtype=dtype, generator=gen)
            ema_update(ema, g_net, 0.999)
            return m

        calls, multi = k_calls(step, k, gen, idx)
        return calls, multi, dict(G=g_net, D=d_net, opt_G=opt_g,
                                  opt_D=opt_d, EMA=ema)

    def f32_run(k):
        calls, multi, named = setup(k, torch.float32, 16, 8, seed=26)
        metrics = torch.cat([c() for c in calls])
        torch.cuda.synchronize()
        return metrics, state_of(**named), multi

    if run == 0:
        hold_k_replay("DCGAN (EMA on)", f32_run)

    k, capturable = STEPS_PER_CALL_RUNS[run]
    # warm calls (K > 1: the eager one, then the capture), 20 timed
    # steps, then the profiled window: one warm call and 4 steps
    warm, n_timed = (3, 20) if k == 1 else (2, 20 // LOOP_K)
    window = 4 // k
    calls, multi, _ = setup(k, torch.bfloat16, GAN_B,
                            (warm + n_timed + 1 + window) * k, seed=30,
                            capturable=capturable)
    for c in calls[:warm]:
        c()
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    ms = time_calls(calls[warm:], k, n_timed)
    timed = dict(kernels.LAUNCHES)
    check(on_new_designs(timed, 5 * n_timed * k), (k, timed))
    launched = timed["convt4x4s2_fused"]
    rest = calls[warm + n_timed:]
    events, _ = warm_profile(
        rest[0], lambda: [c() for c in rest[1:1 + window]])
    busy, n_kernels, n_convt = idle_share(events, 4, ms)
    check(n_convt == 20, f"K={k}: {n_convt} ConvT kernels in the "
          "profiled window of 4 steps, expected 20")
    if multi is not None:
        per = dict(multi.launches_per_replay)
        check(on_new_designs(per, 5 * k)
              and per.get("convt4x4s2_fused", 0) == 5 * k, per)
        names = {e.name for e in events if "convt4x4s2" in e.name
                 and e.device_type == DeviceType.CUDA}
        check(all(any(kn in n for n in names)
                  for kn in (WGMMA_KERNEL, BAND_KERNEL)), names)
        print(f"K={k}: the dispatcher counts {per} ConvT launches per "
              f"replay ({multi.replays} replays); the profiler sees "
              f"{n_convt} ConvT kernels in one replay: "
              f"{sorted(n[:60] for n in names)}")
    print(f"steps-per-call K={k} (bf16, B={GAN_B}, 224 px, EMA on, "
          f"{'capturable' if capturable else 'default'} Adam): "
          f"{ms:.3f} ms per step (mean of {n_timed * k} warm), "
          f"{GAN_B / ms * 1e3:.1f} imgs/s; profiled window of 4 steps: "
          f"{n_kernels} kernels, {busy:.3f} device ms per step, device "
          f"idle share ~{1 - busy / ms:.3f} [{smi}]")
    return [launched, ms]


def read_trace(trace_dir: str):
    """The one ``*.pt.trace.json`` that ``maybe_trace`` wrote into
    ``trace_dir``: (its file name, its events, the launches whose kernel
    the trace lacks: in the window's ``trace_lead``, after it). Fails on
    a launch after the lead without its kernel."""
    traces = os.listdir(trace_dir)
    check(len(traces) == 1 and traces[0].endswith(".pt.trace.json"), traces)
    with open(os.path.join(trace_dir, traces[0])) as f:
        events = json.load(f)["traceEvents"]
    lead = [e for e in events if e.get("cat") == "user_annotation"
            and e.get("name") == "trace_lead"]
    check(len(lead) == 1, lead)
    lead_end = lead[0]["ts"] + lead[0]["dur"]
    seen = {e["args"].get("correlation") for e in events
            if e.get("cat") == "kernel"}
    lost = [e for e in events if e.get("cat") == "cuda_runtime"
            and "LaunchKernel" in e.get("name", "")
            and e["args"].get("correlation") not in seen]
    after = [e for e in lost if e["ts"] > lead_end]
    end = max(e["ts"] + e.get("dur", 0) for e in events if "ts" in e)
    check(not after, f"{traces[0]}: {len(after)} launches without their "
          f"kernel after the lead (of {len(lost)} lost), at us after the "
          f"lead / before the window's end: "
          + ", ".join(f"{e['ts'] - lead_end:.0f}/{end - e['ts']:.0f}"
                      for e in after[:12]))
    return traces[0], events, (len(lost), len(after))


HERE = os.path.dirname(os.path.abspath(__file__))


def cli_process(module: str, argv: list) -> None:
    """``python -m xgan_torch.cli.<module> argv`` in a process of its own,
    as a user runs it; fails with its output's tail unless it exits 0."""
    p = subprocess.run([sys.executable, "-u", "-m", f"xgan_torch.cli.{module}",
                        *argv], stdout=subprocess.PIPE,
                       stderr=subprocess.STDOUT, text=True, cwd=HERE,
                       timeout=600)
    check(p.returncode == 0, f"{module}: exit {p.returncode}\n"
          + p.stdout[-3000:])


def save_store(store, tmp: str) -> None:
    """The host train store, for :func:`in_fresh_process`."""
    np.save(os.path.join(tmp, "train_images.npy"), store.images)
    np.save(os.path.join(tmp, "train_labels.npy"), store.labels)


# interpreters of this script that have imported torch (~8 s on the card's
# host) and wait on stdin for one --phase command (--wait)
WARM = []
WARM_N = 2  # the most that one fresh phase takes at once (two ranks)


def warm_interpreters() -> None:
    """Tops the waiting interpreters up to ``WARM_N``: each imports torch
    now, beside whatever runs, instead of when a fresh phase needs it. No
    CUDA work runs in one before its command, so the phase's profiler
    window is still the first of its process (C6)."""
    while len(WARM) < WARM_N:
        WARM.append(subprocess.Popen(
            [sys.executable, "-u", os.path.abspath(__file__), "--wait"],
            stdin=subprocess.PIPE, stdout=subprocess.DEVNULL,
            stderr=subprocess.DEVNULL, text=True, cwd=HERE))


@atexit.register
def close_interpreters() -> None:
    """Ends the waiting interpreters (their stdin closed, each exits)."""
    while WARM:
        p = WARM.pop()
        p.stdin.close()
        p.wait(timeout=60)


def interpreter(argv: list, env: dict, log: str):
    """A process of this script running ``argv`` (``--phase ...``) with
    ``env``'s variables set (and the launch's others unset), its stdout
    and stderr in the file ``log``: a waiting interpreter when there is
    one (then topped up again), else a new one."""
    if WARM:
        p = WARM.pop(0)
        p.stdin.write(json.dumps({"argv": argv, "env": env, "log": log})
                      + "\n")
        p.stdin.close()
        warm_interpreters()
        return p
    with open(log, "w") as f:
        return subprocess.Popen(
            [sys.executable, "-u", os.path.abspath(__file__), *argv],
            stdout=f, stderr=subprocess.STDOUT, text=True, cwd=HERE,
            env={**{k: v for k, v in os.environ.items()
                    if k not in LAUNCH_KEYS}, **env})


def wait_command() -> list:
    """The ``--wait`` side of :func:`interpreter`: blocks for the command,
    sends stdout and stderr to its log, sets its environment and returns
    its argv (empty when stdin closed without one)."""
    line = sys.stdin.readline()
    if not line:
        return []
    cmd = json.loads(line)
    fd = os.open(cmd["log"], os.O_WRONLY | os.O_CREAT | os.O_TRUNC)
    os.dup2(fd, 1)
    os.dup2(fd, 2)
    for k in LAUNCH_KEYS:
        os.environ.pop(k, None)
    os.environ.update(cmd["env"])
    global START
    START = time.perf_counter()  # the phase's clock, not the wait's
    return cmd["argv"]


def in_fresh_process(phase: str, tmp: str, smi: str):
    """Runs ``FRESH_PHASES[phase]`` in a new process of this script
    (``--phase``) on the train store that :func:`save_store` left in
    ``tmp``; prints its output and returns its result. These phases hold
    a kernel count read from a profiler window, and such a window is
    then the first of its process: late in this long process, windows on
    the card have lost kernel records (C6, ROADMAP.md)."""
    log = os.path.join(tmp, f"{phase.replace('/', '_')}.log")
    p = interpreter(["--phase", phase, tmp, smi], {}, log)
    try:
        p.wait(timeout=900)
    finally:
        if p.poll() is None:
            p.kill()
            p.wait()
    with open(log) as f:
        lines = f.read().splitlines()
    results = [ln for ln in lines if ln.startswith('{"result": ')]
    print("\n".join(ln for ln in lines if ln not in results))
    check(p.returncode == 0 and len(results) == 1,
          f"phase {phase} in its own process: exit {p.returncode}; the "
          f"end of its output:\n" + "\n".join(lines[-40:]))
    return json.loads(results[0])["result"]


def phase_child(phase: str, tmp: str, smi: str) -> None:
    """The ``--phase`` side of :func:`in_fresh_process`."""
    from xgan_torch.data.store import ImageStore
    check(torch.cuda.is_available(), "no CUDA device")
    # as phase_kernels leaves them in the parent process
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    train = ImageStore(np.load(os.path.join(tmp, "train_images.npy")),
                       np.load(os.path.join(tmp, "train_labels.npy")), SIZE)
    name, _, run = phase.partition("/")
    global CHILD_TMP
    CHILD_TMP = tmp
    result = FRESH_PHASES[name](train, smi, int(run or 0))
    print(json.dumps({"result": result}))


def gan_cli_argv(tmp: str, root: str, out: str, *extra) -> list:
    """The DCGAN CLI at full width on the RSNA tree, into ``out``."""
    return ["--data-dir", root, "--model-dir", os.path.join(out, "models"),
            "--output-dir", os.path.join(out, "results"),
            "--results-dir", os.path.join(out, "metrics"),
            "--figures-dir", os.path.join(out, "figures"),
            "--cache-dir", os.path.join(tmp, "cache"), "--workers", "8",
            "--image-size", str(SIZE), "--feature-maps-g", str(FG),
            "--feature-maps-d", str(FG), "--latent-dim", str(LATENT),
            "--batch-size", str(GAN_B), "--save-interval", "1000", *extra]


def state_dicts_close(a_path: str, b_path: str, rel: float):
    """(max relative diff, bitwise) of two ``.pth`` state dicts; fails
    above ``rel`` of each tensor's largest magnitude."""
    a = torch.load(a_path, weights_only=True)
    b = torch.load(b_path, weights_only=True)
    check(set(a) == set(b), (a_path, sorted(set(a) ^ set(b))))
    worst, bitwise = 0.0, True
    for k, v in a.items():
        d = (b[k].double() - v.double()).abs().max().item()
        scale = max(v.double().abs().max().item(), 1e-30)
        worst = max(worst, d / scale)
        bitwise = bitwise and torch.equal(b[k], v)
    check(worst <= rel, (a_path, worst))
    return worst, bitwise


def phase_loop_cli(tmp: str, root: str, train_store, smi: str) -> int:
    """The loop features through the CLIs on the card at full width:

    - resume: the DCGAN CLI (f32, TF32 off, deterministic cuDNN, EMA on)
      for 2 epochs of 2 steps against 1 epoch and then ``--resume-from
      auto``: history and final G, D and EMA within 1e-6 relative;
    - the boundary's blocked time with async saves (the loop's four
      calls on a bf16 B = 128 training state), against the bytes written;
    - preemption: the DCGAN CLI in a subprocess, SIGTERM after its first
      epoch: exit 0, the notice, ``snapshot_last.pth``; then ``--resume-
      from auto`` completes the epochs;
    - the EMA generator of the resume run through the sampler CLI (5
      launches a batch); ``--trace-dir`` on the DCGAN CLI (one trace
      naming the ConvT kernel); WGAN-GP and CGAN with ``--ema-decay 0.999
      --resume-from auto``, 1 + 1 epochs of 2 steps, ending with their
      EMA files.

    Returns the ConvT launches of the counted runs."""
    import signal
    import threading
    from xgan_torch import kernels
    from xgan_torch.cli.generate_synthetic import main as sample_main
    from xgan_torch.cli.train_cgan import main as cgan_main
    from xgan_torch.cli.train_gan import main as gan_main
    from xgan_torch.cli.train_wggan import main as wgan_main
    from xgan_torch.data.pipeline import DeviceStore
    from xgan_torch.native.png import decode_png
    from xgan_torch.train.ema import ema_update, init_ema
    from xgan_torch.train.gan import dcgan_step
    from xgan_torch.train.snapshot import SnapshotManager, run_state
    launched = 0

    # resume: straight against stopped and resumed, f32
    base = ["--epochs", "2", "--limit-batches", "2", "--checkpoint-interval",
            "1", "--ema-decay", "0.999", "--compute-dtype", "f32"]
    runs = {name: os.path.join(tmp, "loop", name)
            for name in ("straight", "resumed")}
    torch.backends.cudnn.deterministic = True
    try:
        kernels.reset_launch_counts()
        straight = gan_main(gan_cli_argv(tmp, root, runs["straight"], *base))
        first = gan_main(gan_cli_argv(tmp, root, runs["resumed"], *base[:1],
                                      "1", *base[2:]))
        resumed = gan_main(gan_cli_argv(tmp, root, runs["resumed"], *base,
                                        "--resume-from", "auto"))
        torch.cuda.synchronize()
    finally:
        torch.backends.cudnn.deterministic = False
    launched += kernels.LAUNCHES["convt4x4s2_fused"]
    check(len(first["G_losses_iter"]) == 2
          and len(resumed["G_losses_iter"]) == 4, (first, resumed))
    worst_h = max(abs(b - a) / max(abs(a), 1e-30)
                  for key in straight
                  for a, b in zip(straight[key], resumed[key]))
    check(worst_h <= 1e-6, worst_h)
    print(f"resume (f32, B={GAN_B}, 2 epochs x 2 steps, EMA 0.999): the "
          f"resumed history within {worst_h:.3g} relative of the straight "
          f"one (bitwise {resumed == straight})")
    for name in ("generator_final.pth", "discriminator_final.pth",
                 "generator_ema_final.pth"):
        rel, bitwise = state_dicts_close(
            os.path.join(runs["straight"], "models", "gan", name),
            os.path.join(runs["resumed"], "models", "gan", name), 1e-6)
        print(f"  {name}: max relative diff {rel:.3g} (limit 1e-6), "
              f"bitwise {bitwise}")

    # the boundary: the loop's four calls with a step in flight
    dev = torch.device("cuda")
    store = DeviceStore(train_store, dev)
    g_net, d_net, opt_g, opt_d = gan_models(torch.bfloat16, seed=40)
    ema, gen = init_ema(g_net), torch.Generator(dev).manual_seed(41)
    bdir = os.path.join(tmp, "loop", "boundary")
    os.makedirs(bdir)
    mgr = SnapshotManager(os.path.join(bdir, "snapshot_last.pth"),
                          async_io=True)
    history = {"G_losses_iter": [0.5] * 1000}
    for epoch in (1, 2):
        for _ in range(2):
            dcgan_step(g_net, d_net, opt_g, opt_d, store.images,
                       torch.randint(0, len(store), (GAN_B,), device=dev,
                                     generator=gen),
                       latent_dim=LATENT, dtype=torch.bfloat16,
                       generator=gen)
            ema_update(ema, g_net, 0.999)
        t0 = time.perf_counter()
        mgr.save_file(os.path.join(bdir, f"generator_epoch_{epoch:03d}.pth"),
                      g_net.state_dict())
        mgr.save_file(os.path.join(bdir,
                                   f"discriminator_epoch_{epoch:03d}.pth"),
                      d_net.state_dict())
        mgr.save(run_state({"g": g_net, "d": d_net},
                           {"g": opt_g, "d": opt_d}, ema, gen), epoch,
                 2 * epoch)
        mgr.save_json(os.path.join(bdir, "history.json"), history)
        blocked = time.perf_counter() - t0
        mgr.flush()
        drained = time.perf_counter() - t0
        sizes = {n: os.path.getsize(os.path.join(bdir, n))
                 for n in os.listdir(bdir)}
        snap_mb = sizes["snapshot_last.pth"] / 1e6
        ckpt_mb = sum(v for n, v in sizes.items() if "epoch" in n and
                      f"{epoch:03d}" in n) / 1e6
        print(f"boundary {epoch} (bf16 DCGAN-224, B={GAN_B}, EMA on, async "
              f"saves, a step in flight): the loop blocked "
              f"{blocked * 1e3:.1f} ms for a {snap_mb:.1f} MB snapshot + "
              f"{ckpt_mb:.1f} MB of checkpoints + the history; the writer "
              f"drained {drained * 1e3:.1f} ms after the first call [{smi}]")
    del g_net, d_net, opt_g, opt_d, ema, store
    torch.cuda.empty_cache()

    # preemption: SIGTERM to the CLI in a subprocess after its first epoch
    pre = os.path.join(tmp, "loop", "preempt")
    epochs = 20
    argv = gan_cli_argv(tmp, root, pre, "--epochs", str(epochs),
                        "--limit-batches", "1", "--compute-dtype", "bf16")
    here = os.path.dirname(os.path.abspath(__file__))
    p = subprocess.Popen([sys.executable, "-u", "-m", "xgan_torch.cli."
                          "train_gan", *argv], stdout=subprocess.PIPE,
                         stderr=subprocess.STDOUT, text=True, cwd=here)
    sent, lines = False, []
    watchdog = threading.Timer(300, p.kill)  # a hung child fails the phase
    watchdog.start()
    try:
        for ln in p.stdout:
            lines.append(ln)
            if not sent and f"Epoch 1/{epochs} Summary" in ln:
                p.send_signal(signal.SIGTERM)
                sent = True
        rc = p.wait(timeout=300)
    finally:
        watchdog.cancel()
        if p.poll() is None:
            p.kill()
            p.wait()
    text = "".join(lines)
    snap_path = os.path.join(pre, "models", "gan", "snapshot_last.pth")
    check(sent and rc == 0 and "Received signal" in text
          and "Preempted: training stopped after epoch" in text
          and os.path.exists(snap_path), text[-3000:])
    stopped = torch.load(snap_path, weights_only=True)["epoch"]
    kernels.reset_launch_counts()
    hist = gan_main(argv + ["--resume-from", "auto"])
    torch.cuda.synchronize()
    launched += kernels.LAUNCHES["convt4x4s2_fused"]
    check(len(hist["G_losses_epoch"]) == epochs, len(hist["G_losses_epoch"]))
    print(f"preemption: SIGTERM after epoch 1 of {epochs}: exit {rc}, the "
          f"run stopped after epoch {stopped} with snapshot_last.pth; "
          f"--resume-from auto trained epochs {stopped + 1}-{epochs} "
          f"(history of {epochs} epochs)")

    # the EMA generator through the sampler
    kernels.reset_launch_counts()
    stats = sample_main([
        "--model-path", os.path.join(runs["resumed"], "models", "gan",
                                     "generator_ema_final.pth"),
        "--output-dir", os.path.join(tmp, "loop", "ema_synth"),
        "--num-images", str(B), "--latent-dim", str(LATENT),
        "--feature-maps-g", str(FG), "--image-size", str(SIZE),
        "--batch-size", str(B), "--compute-dtype", "bf16"])
    torch.cuda.synchronize()
    ema_launches = dict(kernels.LAUNCHES)
    launched += ema_launches.get("convt4x4s2_fused", 0)
    check(stats["written"] == B and on_new_designs(ema_launches, 5),
          (stats, ema_launches))
    img = decode_png(os.path.join(tmp, "loop", "ema_synth",
                                  f"synthetic_{B:05d}.png"))
    check(img.shape == (SIZE, SIZE, 3), img.shape)
    print(f"EMA generator -> sampler: {stats['written']} PNGs from "
          f"generator_ema_final.pth, launches {ema_launches}")

    # --trace-dir: one trace, naming the ConvT kernel; the CLI in a fresh
    # process, as a user runs it (windows late in this long process have
    # lost kernel records, C6)
    trace_dir = os.path.join(tmp, "loop", "trace")
    cli_process("train_gan", gan_cli_argv(
        tmp, root, os.path.join(tmp, "loop", "traced"), "--epochs", "2",
        "--limit-batches", "2", "--compute-dtype", "bf16", "--trace-dir",
        trace_dir))
    name, events, (lost, _) = read_trace(trace_dir)
    ours = [e for e in events if e.get("cat") == "kernel"
            and "convt4x4s2" in e.get("name", "")]
    # epoch 2: 2 train steps and the final sheet, 5 ConvT kernels each
    check(len(ours) == 15
          and all(any(kn in e["name"] for e in ours)
                  for kn in (WGMMA_KERNEL, BAND_KERNEL)),
          (len(ours), [e.get("name") for e in ours][:4]))
    print(f"--trace-dir: one trace ({name}, "
          f"{os.path.getsize(os.path.join(trace_dir, name)) / 1e6:.1f} MB) "
          f"of epoch 2, {len(ours)} ConvT kernels in it; {lost} launches "
          f"without their kernel, all in the window's lead")

    # WGAN-GP and CGAN: EMA and resume, 1 + 1 epochs of 2 steps
    for name, main, sub, extra in (
            ("WGAN-GP", wgan_main, "wgan",
             ["--batch-size", str(WGAN_B), "--critic-iters",
              str(WGAN_CRITIC)]),
            ("CGAN", cgan_main, "cgan",
             ["--batch-size", str(CGAN_B), "--feature-maps-g",
              str(CGAN_FM), "--feature-maps-d", str(CGAN_FM)])):
        out = os.path.join(tmp, "loop", sub)
        argv = gan_cli_argv(tmp, root, out, "--limit-batches", "2",
                            "--compute-dtype", "bf16", "--ema-decay",
                            "0.999", "--resume-from", "auto", *extra)
        main(argv + ["--epochs", "1"])
        kernels.reset_launch_counts()
        hist = main(argv + ["--epochs", "2"])
        torch.cuda.synchronize()
        counted = dict(kernels.LAUNCHES)
        launched += counted.get("convt4x4s2_fused", 0)
        ema_path = os.path.join(out, "models", sub, "generator_ema_final.pth")
        check(os.path.exists(ema_path), ema_path)
        first_key = "D_losses" if sub == "wgan" else "G_losses_iter"
        want_len = 2 * 2 * (WGAN_CRITIC if sub == "wgan" else 1)
        check(len(hist[first_key]) == want_len, (name, len(hist[first_key])))
        check((counted.get("convt4x4s2_mma", 0) > 0) == (sub == "wgan"),
              (name, counted))
        print(f"{name}: 1 epoch, then --resume-from auto for the second "
              f"(2 steps each, EMA 0.999): {len(hist[first_key])} "
              f"{first_key} entries, generator_ema_final.pth written; "
              f"launches of the resumed run {counted}")
    return launched



def k_calls(step, k: int, gen, idx, *inputs):
    """The calls that run ``step(idx[t], *inputs)`` over the rows of
    ``idx``: one eager step each (K = 1, each returning a (1, M) tensor) or
    one :class:`StepsPerCall` of K steps each (a replay from its second
    call). Returns (the calls, the dispatcher or None)."""
    from xgan_torch.train.multistep import StepsPerCall
    if k == 1:
        return [lambda t=t: step(idx[t], *inputs)[None]
                for t in range(len(idx))], None
    multi = StepsPerCall(step, k, gen)
    return [lambda t=t: multi(idx[t:t + k], *inputs)
            for t in range(0, len(idx), k)], multi


def hold_k_replay(label: str, run, b: int = 16) -> None:
    """f32 steps (B = ``b``, TF32 off, deterministic cuDNN) as K = 1 eager
    steps and as K = LOOP_K (the first call eager, the later ones graph
    replays), each with the trainers' capturable Adam, from the same
    weights, draws and indices: the metrics and every state tensor within
    LOOP_TOL. ``run(k)`` returns (the stacked metrics, the state by name,
    the dispatcher or None)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    try:
        out = {k: run(k) for k in (1, LOOP_K)}
    finally:
        torch.backends.cudnn.deterministic = False
    (m_k, s_k, multi), (m_1, s_1, _) = out[LOOP_K], out[1]
    check(multi.replays >= 1, multi.replays)
    torch.testing.assert_close(m_k, m_1, **LOOP_TOL)
    worst, bitwise = (m_k - m_1).abs().max().item(), torch.equal(m_k, m_1)
    for key, v in s_1.items():
        torch.testing.assert_close(s_k[key], v, msg=key, **LOOP_TOL)
        worst = max(worst, (s_k[key].float() - v.float()).abs().max().item())
        bitwise = bitwise and torch.equal(s_k[key], v)
    print(f"{label}: f32 K={LOOP_K} graph replays vs K=1 eager, "
          f"{m_1.shape[0]} steps (B={b}, the trainer's capturable Adam, "
          f"{multi.replays} replays): metrics and state within "
          f"rtol 2e-4, atol 2e-5: max |diff| {worst:.3g}; bitwise equal "
          f"{bitwise}")


def state_of(**named) -> dict:
    """Name -> a copy of each module's (or EMA dict's) tensors and each
    optimizer's state tensors."""
    from xgan_torch.parallel.tp import ShardedAdam
    out = {}
    for name, obj in named.items():
        if isinstance(obj, (torch.optim.Optimizer, ShardedAdam)):
            items = [(f"{i}.{k}", v) for i, st in enumerate(
                obj.state_dict()["state"].values()) for k, v in st.items()]
        elif isinstance(obj, torch.nn.Module):
            items = obj.state_dict().items()
        else:
            items = obj.items()
        out.update({f"{name}.{k}": v.detach().clone() for k, v in items
                    if torch.is_tensor(v)})
    return out


def time_calls(calls, steps_per_call: int, n_timed: int) -> float:
    """ms per step of ``calls[:n_timed]``, ending in a synchronize."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for c in calls[:n_timed]:
        m = c()
    torch.cuda.synchronize()
    check(bool(torch.isfinite(m).all()), m)
    return (time.perf_counter() - t0) / (n_timed * steps_per_call) * 1e3


# (K, A) of each run of phase_loop_wgan
WGAN_LOOP_RUNS = ((1, 1), (LOOP_K, 1), (1, LOOP_A))


def phase_loop_wgan(train_store, smi: str, run: int) -> list:
    """WGAN-GP's loop flags on the card, run ``WGAN_LOOP_RUNS[run]`` (run
    0 first holds the f32 checks), one run a process so that its profiled
    window is the first of its process (C6, ROADMAP.md):

    - one f32 A = 2 step (B = 16, 2 critic updates, after 3 shared warm-up
      steps) through the kernel against the plain version, held as the
      DCGAN A = 2 step (:func:`hold_f32_kernel_step`, its TF32 control
      included), the gradient norms of G and the critic;
    - :func:`hold_k_replay` of the WGAN-GP step (2 critic updates, EMA
      on): the graph captures the penalty's double backward and the
      ConvT kernel;
    - bf16 at B = 64, 5 critic updates: ms per step and, from one
      profiled window, the device idle share for K = 1 and K = 4, and
      for A = 1 and A = 4 with the peak memory of a step; the ConvT
      launches per step (5 (critic_iters + 1) A) and per replay (K times
      5 (critic_iters + 1)) against the wrappers' and the dispatcher's
      counts and a profiler trace of one replay, which must show the
      tensor-core kernel.

    Returns [the launches of the counted steps, ms per step]."""
    import copy
    from torch.autograd import DeviceType
    from xgan_torch import kernels
    from xgan_torch.data.pipeline import DeviceStore
    from xgan_torch.kernels.convt import convt4x4s2_fused_ref
    from xgan_torch.train.ema import ema_update, init_ema
    from xgan_torch.train.wgan import wgan_step
    dev = torch.device("cuda")
    store = DeviceStore(train_store, dev)
    n = 2

    if run == 0:
        # f32 A = 2 through the kernel against the plain version
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cudnn.deterministic = True
        b = 16
        conv_rel = convt_rel_rms(b, WGAN_WIDTHS)
        g = torch.Generator(device=dev).manual_seed(50)
        idx = torch.randint(0, len(store), (b,), generator=g, device=dev)
        draws = {"flip": torch.rand(b, generator=g, device=dev) < 0.5,
                 "noises": [torch.randn(b, LATENT, generator=g, device=dev)
                            for _ in range(n)],
                 "alphas": [torch.rand(b, 1, 1, 1, generator=g, device=dev)
                            for _ in range(n)],
                 "g_noise": torch.randn(b, LATENT, generator=g, device=dev)}
        nets = wgan_models(torch.float32, seed=51)
        fresh = copy.deepcopy([m.state_dict() for m in nets])
        for _ in range(3):
            wgan_step(*nets, store.images,
                      torch.randint(0, len(store), (b,), generator=g,
                                    device=dev),
                      latent_dim=LATENT, critic_iters=n, lambda_gp=10.0,
                      convt=convt4x4s2_fused_ref, generator=g, grad_accum=2)
        warm = copy.deepcopy([m.state_dict() for m in nets])

        def f32_step(convt):
            kw = {} if convt is None else {"convt": convt}
            return wgan_step(*nets, store.images, idx, latent_dim=LATENT,
                             critic_iters=n, lambda_gp=10.0, grad_accum=2,
                             **draws, **kw)

        hold_f32_kernel_step(
            f"A=2 WGAN-GP step (B={b}, {n} critic updates)", nets, fresh,
            warm, f32_step, 5 * (n + 1) * 2,
            lambda: [*nets[0].parameters(), *nets[1].parameters()], conv_rel)
        del nets, fresh, warm

    def setup(k, dtype, b, steps, critic_iters, seed, accum=1):
        g_net, c_net, opt_g, opt_c = wgan_models(dtype, seed=seed,
                                                 capturable=True)
        ema = init_ema(g_net)
        gen = torch.Generator(dev).manual_seed(seed + 2)
        idx = torch.randint(0, len(store), (steps, b), device=dev,
                            generator=torch.Generator(dev).manual_seed(
                                seed + 3))

        def step(i):
            m = wgan_step(g_net, c_net, opt_g, opt_c, store.images, i,
                          latent_dim=LATENT, critic_iters=critic_iters,
                          lambda_gp=10.0, dtype=dtype, generator=gen,
                          grad_accum=accum)
            ema_update(ema, g_net, 0.999)
            return m

        calls, multi = k_calls(step, k, gen, idx)
        return calls, multi, dict(G=g_net, C=c_net, opt_G=opt_g,
                                  opt_C=opt_c, EMA=ema)

    def f32_run(k):
        calls, multi, named = setup(k, torch.float32, 16, 8, n, seed=52)
        metrics = torch.cat([c() for c in calls])
        torch.cuda.synchronize()
        return metrics, state_of(**named), multi

    if run == 0:
        hold_k_replay(f"WGAN-GP ({n} critic updates, EMA on)", f32_run)

    # bf16 at the trainer's batch
    per_step = 5 * (WGAN_CRITIC + 1)
    k, accum = WGAN_LOOP_RUNS[run]
    # 2 warm calls (K > 1: the eager one, then the capture), the timed
    # ones, 2 for the profiled window
    n_timed = (8 if accum == 1 else 4) if k == 1 else 2
    calls, multi, named = setup(k, torch.bfloat16, WGAN_B,
                                (4 + n_timed) * k, WGAN_CRITIC, seed=54,
                                accum=accum)
    warm_calls = 2
    for c in calls[:warm_calls]:
        c()
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    ms = time_calls(calls[warm_calls:], k, n_timed)
    peak = torch.cuda.max_memory_allocated()
    timed = dict(kernels.LAUNCHES)
    want = per_step * accum * n_timed * k
    check(on_new_designs(timed, want)
          and timed.get("convt4x4s2_fused", 0) == want,
          (k, accum, timed, want))
    launched = timed["convt4x4s2_fused"]
    rest = calls[warm_calls + n_timed:]
    events, _ = warm_profile(rest[0], rest[1])
    busy, n_kernels, n_convt = idle_share(events, k, ms)
    check(n_convt == per_step * accum * k,
          f"K={k}, A={accum}: {n_convt} ConvT kernels in the profiled "
          f"window of {k} steps, expected {per_step * accum * k}")
    if multi is not None:
        per = dict(multi.launches_per_replay)
        check(on_new_designs(per, per_step * k)
              and per.get("convt4x4s2_fused", 0) == per_step * k, per)
        names = {e.name for e in events if "convt4x4s2" in e.name
                 and e.device_type == DeviceType.CUDA}
        check(all(any(kn in nm for nm in names)
                  for kn in (WGMMA_KERNEL, BAND_KERNEL)), names)
        print(f"WGAN-GP K={k}: the dispatcher counts {per} ConvT "
              f"launches per replay ({multi.replays} replays); the "
              f"profiler sees {n_convt} ConvT kernels in one replay: "
              f"{sorted(nm[:60] for nm in names)}")
    print(f"WGAN-GP K={k}, A={accum} (bf16, B={WGAN_B}, {WGAN_CRITIC} "
          f"critic updates, 224 px, EMA on, capturable Adam): {ms:.3f} "
          f"ms per step (mean of {n_timed * k} warm), "
          f"{WGAN_B / ms * 1e3:.1f} imgs/s; ConvT launches "
          f"{timed['convt4x4s2_fused'] // (n_timed * k)} a step; peak "
          f"memory {peak / 2**30:.3f} GiB ({(peak - before) / 2**30:.3f} "
          f"GiB above the {before / 2**30:.3f} held); profiled window of "
          f"{k} step(s): {n_kernels} kernels, {busy:.3f} device ms per "
          f"step, device idle share ~{1 - busy / ms:.3f} [{smi}]")
    return [launched, ms]


def phase_loop_cgan(train_store, smi: str) -> None:
    """CGAN's loop flags on the card (no hand-written kernel launches):

    - :func:`hold_k_replay` of the CGAN step (EMA on), 12 steps: at
      K = 4 an eager call and a captured one at epoch 0, then a replay at
      epoch 5 (the epoch a device input of the graph);
    - a replay at epoch 5 with the gate held open and one with it held
      closed (D's projection pinned as in phase_cgan_profile): after the
      closed replay D's parameters and Adam state are bitwise those before
      it and its BN buffers have moved; after the open one they moved;
    - one f32 A = 2 step (B = 16) on the card against the CPU, held as
      phase_cgan_step_check holds A = 1 (after 3 warm-up steps, its
      floor rule and TF32 control);
    - bf16 at B = 32: ms per step for K = 1 and K = 4 (the closed gate's
      cost under the select is read in phase_cgan_profile).

    Every kernel launch count stays 0."""
    from xgan_torch import kernels
    from xgan_torch.data.pipeline import DeviceStore
    from xgan_torch.models.cgan import SEQ_D_BN
    from xgan_torch.train.cgan import GATE_EPOCHS, cgan_step
    from xgan_torch.train.ema import ema_update, init_ema
    dev = torch.device("cuda")
    store = DeviceStore(train_store, dev)
    kernels.reset_launch_counts()
    epochs = [0, GATE_EPOCHS]

    def setup(k, dtype, b, steps, seed, pin=None):
        nets = cgan_models(dev, dtype, seed=seed, capturable=True)
        ema = init_ema(nets[0])
        gen = torch.Generator(dev).manual_seed(seed + 2)
        idx = torch.randint(0, len(store), (steps, b), device=dev,
                            generator=torch.Generator(dev).manual_seed(
                                seed + 3))
        labels, draws = store.labels, {}
        if pin is not None:  # the gate held open (False) or closed (True)
            d = nets[1]
            emb, bn = d.label_emb.weight, d.main[SEQ_D_BN[-1]]
            c = 500.0 / emb.shape[1] * (1 if pin else -1)
            with torch.no_grad():
                emb[0], emb[1] = c, -c
                bn.weight.zero_()
                bn.bias.fill_(1.0)
            labels = torch.zeros_like(store.labels)
            draws["fake_labels"] = torch.ones(b, dtype=torch.int64,
                                              device=dev)

        def step(i, epoch):
            m = cgan_step(*nets, store.images, labels, i, epoch,
                          latent_dim=LATENT, dtype=dtype, generator=gen,
                          **draws)
            ema_update(ema, nets[0], 0.999)
            return m

        return nets, ema, gen, idx, step

    def f32_run(k):
        # 12 steps: a graph captured at epoch 0 replays at epoch 5
        nets, ema, gen, idx, step = setup(k, torch.float32, 16, 12, seed=60)
        e = torch.tensor(0, device=dev)
        calls, multi = k_calls(step, k, gen, idx, e)
        out = []
        for j, c in enumerate(calls):
            e.fill_(0 if j < 2 * len(calls) // 3 else GATE_EPOCHS)
            out.append(c())
        torch.cuda.synchronize()
        named = dict(G=nets[0], D=nets[1], opt_G=nets[3], opt_D=nets[4],
                     EMA=ema)
        return torch.cat(out), state_of(**named), multi

    hold_k_replay("CGAN (epochs 0, 0, 5 a call at K = 4; EMA on)", f32_run)

    # one dispatcher, replays at epoch 5 with the gate held open, closed
    for closed in (False, True):
        nets, ema, gen, idx, step = setup(LOOP_K, torch.float32, 16, 12,
                                          seed=62, pin=closed)
        e = torch.tensor(0, device=dev)
        calls, multi = k_calls(step, LOOP_K, gen, idx, e)
        calls[0]()  # eager, epoch 0
        calls[1]()  # capture and the first replay, epoch 0
        e.fill_(GATE_EPOCHS)
        d, opt_d = nets[1], nets[4]
        torch.cuda.synchronize()
        before = state_of(D=d, opt_D=opt_d)
        bn = [t.clone() for t in d.buffers()]
        m = calls[2]()
        torch.cuda.synchronize()
        after = state_of(D=d, opt_D=opt_d)
        same = [torch.equal(after[key], v) for key, v in before.items()
                if "running" not in key and "num_batches" not in key]
        moved = any(not torch.equal(a, b) for a, b in zip(d.buffers(), bn))
        d_x, d_g_z1 = m[:, 2].min().item(), m[:, 3].max().item()
        check(multi.replays == 2 and moved, (multi.replays, moved))
        check((d_x >= 0.8 and d_g_z1 <= 0.2) == closed, (closed, d_x, d_g_z1))
        check(all(same) if closed else not all(same), (closed, same))
        print(f"CGAN K={LOOP_K} replay at epoch {GATE_EPOCHS} of a graph "
              f"captured at epoch 0, gate held "
              f"{'closed' if closed else 'open'}"
              f" (D(x) >= {d_x:.3f}, D(G(z)) <= {d_g_z1:.3f}): D's parameters "
              f"and Adam state bitwise unchanged {all(same)}; D's BN "
              f"buffers moved {moved}")
        del nets, ema, calls, multi

    phase_cgan_step_check(train_store, grad_accum=2)

    times = {}
    for k in (1, LOOP_K):
        nets, ema, gen, idx, step = setup(k, torch.bfloat16, CGAN_B, 24,
                                          seed=64)
        calls, _ = k_calls(step, k, gen, idx, torch.tensor(0, device=dev))
        for c in calls[:2]:  # K > 1: the eager call, then the capture
            c()
        ms = time_calls(calls[2:], k, 20 if k == 1 else 4)
        times[k] = ms
        print(f"CGAN K={k} (bf16, B={CGAN_B}, 224 px, fg = fd = {CGAN_FM}, "
              f"random VGG16, EMA on, capturable Adam, epoch 0): {ms:.3f} ms "
              f"per step (mean of {20 if k == 1 else 4 * k} warm), "
              f"{CGAN_B / ms * 1e3:.1f} imgs/s [{smi}]")
        del nets, ema, calls
        torch.cuda.empty_cache()
    print(f"CGAN K={LOOP_K} / K=1 step time {times[LOOP_K] / times[1]:.3f}")
    check(sum(kernels.LAUNCHES.values()) == 0, dict(kernels.LAUNCHES))


def phase_loop_classifier(tmp: str, root: str, synth_dir: str, train,
                          synth, smi: str) -> int:
    """The classifier's loop flags through its CLI at full width (ResNet-50
    (3,4,6,3), 224 px, B = 32) on the tree of phase 7:

    - bf16 ``--grad-accum 4`` (augmented, ``--unfreeze``, 1 epoch of 6
      steps): one ``mixed_gather`` launch per train step;
    - the train step of run B's configuration (concat, ``--unfreeze``,
      bf16, B = 32) at A = 1 and A = 4 and with each remat scope: ms per
      step over 10 warm steps, one ``mixed_gather`` a step, and the peak
      memory above the held state; then one f32 step (TF32 off,
      deterministic cuDNN) of the model with each remat scope against one
      without, from the same weights and batch: logits, every gradient
      and the BN running statistics within 1e-6 relative;
    - preemption: a 2-fold run (curriculum, frozen base, f32,
      deterministic cuDNN) in a subprocess gets SIGTERM in the last epoch
      of its first fold: exit 0, the notice, no summary; then
      ``--resume-from auto`` completes it (fold 1 loaded, not retrained),
      and its summary equals a straight run's within 1e-6;
    - ``--trace-dir``: one trace that holds the traced epoch's 3
      ``mixed_gather`` kernels, and every kernel launched after the
      window's lead (:func:`read_trace`).

    Returns the ``mixed_gather`` launches of the counted runs."""
    import copy
    import signal
    import threading
    from xgan_torch import kernels
    from xgan_torch.cli.train_classifier import main as cls_main
    from xgan_torch.data.pipeline import DeviceStore
    from xgan_torch.models.resnet import REMAT_SCOPES, ResNet50
    from xgan_torch.train.classifier import classifier_optimizer, train_step
    out = os.path.join(tmp, "loop_cls")
    launched = 0

    def argv(name, *extra):
        d = os.path.join(out, name)
        return ["--data-dir", root, "--synthetic-dir", synth_dir,
                "--model-dir", os.path.join(d, "models"),
                "--results-dir", os.path.join(d, "metrics"),
                "--figures-dir", os.path.join(d, "figures"),
                "--cache-dir", os.path.join(tmp, "cache"), "--workers", "8",
                "--image-size", str(SIZE), "--batch-size", str(CLS_B),
                *extra]

    def timed_run(name, *extra):
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        result = cls_main(argv(name, *extra))
        torch.cuda.synchronize()
        return result, time.perf_counter() - t0, dict(kernels.LAUNCHES)

    # --grad-accum 4 through the CLI, augmented so that every step gathers
    steps = 6
    result, wall, launches = timed_run(
        "a4", "--use-synthetic", "--unfreeze", "--k-folds", "1", "--epochs",
        "1", "--limit-batches", str(steps), "--compute-dtype", "bf16",
        "--grad-accum", str(LOOP_A))
    gathers = launches.get("mixed_gather", 0)
    launched += gathers
    check(gathers == steps and np.isfinite(result["loss"]),
          (launches, result))
    print(f"classifier CLI --grad-accum {LOOP_A} (augmented, --unfreeze, "
          f"bf16, B={CLS_B}, 1 epoch of {steps} steps): {gathers} "
          f"mixed_gather launches, {gathers / steps:.0f} a train step; run "
          f"{wall:.3f} s [{smi}]")

    # the step at A = 1 and A = 4, and with each remat scope: run B's
    # configuration (concat, --unfreeze), bf16, B = 32, 10 warm steps each
    dev = torch.device("cuda")
    real, syn = DeviceStore(train, dev), DeviceStore(synth, dev)
    gen = torch.Generator(dev).manual_seed(70)
    idx = torch.randint(0, len(real) + len(syn), (14, CLS_B), generator=gen,
                        device=dev)
    times = {}
    for accum, scope in ((1, None), (LOOP_A, None),
                         *((1, sc) for sc in REMAT_SCOPES)):
        model = ResNet50(2, dtype=torch.bfloat16, device=dev,
                         generator=torch.Generator(dev).manual_seed(71),
                         remat=scope is not None,
                         remat_scope=scope or "block")
        opt = classifier_optimizer(model, 1e-3, freeze_base=False)

        def step(i):
            return train_step(model, opt, real, syn, idx[i], mode="concat",
                              dtype=torch.bfloat16, generator=gen,
                              grad_accum=accum)

        for i in range(3):
            step(i)
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        for i in range(3, 13):
            step(i)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) / 10 * 1e3
        peak = torch.cuda.max_memory_allocated()
        check(kernels.LAUNCHES["mixed_gather"] == 10, dict(kernels.LAUNCHES))
        launched += 10
        times[accum, scope] = ms
        print(f"classifier step A={accum}, remat {scope or 'none'} (concat, "
              f"--unfreeze, bf16, B={CLS_B}, 224 px): {ms:.3f} ms per step "
              f"(mean of 10 warm), {CLS_B / ms * 1e3:.1f} imgs/s, one "
              f"mixed_gather a step; peak memory {peak / 2**30:.3f} GiB, "
              f"{(peak - held) / 2**30:.3f} GiB above the "
              f"{held / 2**30:.3f} GiB held [{smi}]")
        del model, opt
        torch.cuda.empty_cache()
    base = times[1, None]
    print("classifier step time against A=1 without remat: "
          + ", ".join(f"A={a} remat {sc or 'none'} {t / base:.3f}"
                      for (a, sc), t in times.items()))

    # one f32 step with remat against one without, from the same weights
    x = torch.randn(CLS_B, SIZE, SIZE, 3, generator=gen, device=dev)
    y = torch.randint(0, 2, (CLS_B,), generator=gen, device=dev)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    try:
        plain = ResNet50(2, device=dev,
                         generator=torch.Generator(dev).manual_seed(72))
        got = {}
        for scope in (None, *REMAT_SCOPES):
            model = copy.deepcopy(plain)
            model.remat = scope is not None
            model.remat_scope = scope or "block"
            logits = model(x, train=True)
            torch.nn.functional.cross_entropy(logits, y).backward()
            got[scope] = (logits.detach(), {k: p.grad for k, p in
                                            model.named_parameters()},
                          {k: v for k, v in model.state_dict().items()
                           if "running" in k})
            del model
    finally:
        torch.backends.cudnn.deterministic = False
    ref = got.pop(None)

    def rel(a, b):
        return ((a.double() - b.double()).abs().max()
                / b.double().abs().max().clamp_min(1e-30)).item()

    for scope, (logits, grads, stats) in got.items():
        worst = max([rel(logits, ref[0])]
                    + [rel(grads[k], v) for k, v in ref[1].items()]
                    + [rel(stats[k], v) for k, v in ref[2].items()])
        check(worst <= 1e-6, (scope, worst))
        print(f"f32 ResNet-50 step, remat {scope} vs none: logits, "
              f"gradients and BN running statistics max relative diff "
              f"{worst:.3g} (limit 1e-6)")
    del plain, got, ref

    # preemption between folds, then --resume-from auto, f32
    cv = ["--use-synthetic", "--use-curriculum", "--curriculum-schedule",
          "0:0.25,1:0.5", "--k-folds", "2", "--epochs", "2",
          "--limit-batches", "3", "--compute-dtype", "f32"]
    torch.backends.cudnn.deterministic = True
    try:
        kernels.reset_launch_counts()
        straight = cls_main(argv("straight", *cv))
        torch.cuda.synchronize()
        launched += kernels.LAUNCHES["mixed_gather"]
        stop_argv = argv("stopped", *cv)
        here = os.path.dirname(os.path.abspath(__file__))
        p = subprocess.Popen(
            [sys.executable, "-u", "-c",
             "import sys, torch; torch.backends.cudnn.deterministic = True; "
             "from xgan_torch.cli.train_classifier import main; "
             "main(sys.argv[1:])", *stop_argv],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            cwd=here)
        sent, lines = False, []
        watchdog = threading.Timer(600, p.kill)
        watchdog.start()
        try:
            for ln in p.stdout:
                lines.append(ln)
                # fold 1's last epoch line: the fold completes, then the
                # run stops before fold 2 (its checkpoint save and test
                # evaluation lie between this line and the flag's read)
                if not sent and "Epoch 2/2 [fold_1_" in ln:
                    p.send_signal(signal.SIGTERM)
                    sent = True
            rc = p.wait(timeout=600)
        finally:
            watchdog.cancel()
            if p.poll() is None:
                p.kill()
                p.wait()
        text = "".join(lines)
        summary_path = os.path.join(out, "stopped", "metrics",
                                    "curriculum_cv_summary.json")
        check(sent and rc == 0 and "Received signal" in text
              and "Preempted: stopping after completed fold 1" in text
              and not os.path.exists(summary_path), text[-3000:])
        kernels.reset_launch_counts()
        resumed = cls_main(stop_argv + ["--resume-from", "auto"])
        torch.cuda.synchronize()
        launched += kernels.LAUNCHES["mixed_gather"]
    finally:
        torch.backends.cudnn.deterministic = False
    check(os.path.exists(summary_path), summary_path)
    worst = max(abs(resumed[part][m] - straight[part][m])
                / max(abs(straight[part][m]), 1e-30)
                for part in ("average", "std_dev")
                for m in straight[part])
    check(worst <= 1e-6, (worst, resumed, straight))
    print(f"classifier preemption: SIGTERM in the last epoch of fold 1 of "
          f"2 (curriculum, f32): exit {rc}, the notice, no summary; "
          f"--resume-from auto "
          f"loaded fold 1 and trained fold 2: summary within {worst:.3g} "
          f"relative of a straight run's (limit 1e-6; bitwise "
          f"{resumed == straight})")

    # --trace-dir: one trace that holds the epoch's 3 gather kernels; the
    # CLI in a fresh process (C6)
    trace_dir = os.path.join(out, "trace")
    cli_process("train_classifier", argv(
        "traced", "--use-synthetic", "--k-folds", "1", "--epochs", "2",
        "--limit-batches", "3", "--compute-dtype", "bf16", "--trace-dir",
        trace_dir))
    name, events, (lost, _) = read_trace(trace_dir)
    ours = [e for e in events if e.get("cat") == "kernel"
            and "mixed_gather" in e.get("name", "")]
    # epoch 2: 3 train steps, one gather each
    check(len(ours) == 3, [e.get("name") for e in events
                           if e.get("cat") == "kernel"][:8])
    print(f"classifier --trace-dir: one trace ({name}) of epoch 2, "
          f"{len(ours)} mixed_gather kernels in it (3 train steps); {lost} "
          f"launches without their kernel, all in the window's lead")
    return launched


# ---- --parallel-folds: the lockstep folds -----------------------------------

PF_K = 5  # the reference's CV folds


def gather_timing_inputs(g, k: int, b: int):
    """Random u8 stores of 4096 real and 1024 synthetic 224-px rows (770
    MB) and 32 sets of (k, b) indices and masks, for timing the
    fold-batched gather: the 32 sets (770 MB of rows at k = 5, B = 32) do
    not fit the 50 MB L2, so a launch that takes the next set reads its
    rows from HBM, as a train step does."""
    dev = torch.device("cuda")
    real = torch.randint(0, 256, (4096, SIZE, SIZE, 3), generator=g,
                         device=dev, dtype=torch.uint8)
    synth = torch.randint(0, 256, (1024, SIZE, SIZE, 3), generator=g,
                          device=dev, dtype=torch.uint8)
    sets = [(torch.randint(0, len(real), (k, b), generator=g, device=dev),
             torch.randint(0, len(synth), (k, b), generator=g, device=dev),
             torch.rand((k, b), generator=g, device=dev) < 0.5)
            for _ in range(32)]
    return real, synth, sets


def _lockstep_models(dev, dtype, k: int, seed: int, freeze: bool):
    """k ResNet-50s from seeds ``seed + f``, their host state dicts, and
    the names a frozen base (``fc.*``) or ``--unfreeze`` trains."""
    from xgan_torch.models.resnet import ResNet50
    models = [ResNet50(2, dtype=dtype, device=dev, generator=torch.Generator(
        dev).manual_seed(seed + f)) for f in range(k)]
    names = [n for n, _ in models[0].named_parameters()
             if not freeze or n.startswith("fc.")]
    return models, names


def phase_parallel_folds(tmp: str, root: str, synth_dir: str, train, synth,
                         smi: str) -> int:
    """``--parallel-folds`` at full width (ResNet-50, 224 px, B = 32):

    - the fold-batched ``mixed_gather`` (k = 5, (5, 32) indices, one
      launch) bitwise against its plain version and against 5 single
      launches; a bad index in one fold raises; its time, the plain
      version's, 5 single launches' and ``torch.where``'s;
    - one f32 lockstep step (TF32 off, deterministic cuDNN, k = 5, B = 16,
      ``--unfreeze``, a padded tail in one fold) against the 5 sequential
      fold steps on the card: per-fold losses within 1e-4 (1 + |ref|),
      every gradient norm of every fold within 1e-3 plus twice the floor
      that rounding sets in that fold: the largest relative change of
      any of its gradient norms over four draws, the sequential steps on
      their batches' rows in two other orders (every batch reduction,
      BN's one-pass statistics among them, summed in another order, as
      the grouped step sums them) and with 1e-6 rms noise on every conv
      output (the CGAN check's stand-in for another f32 implementation);
      the same lockstep step with TF32 on must fail those limits;
    - the freeze: a lockstep step in which one fold's mask is all zeros
      leaves its parameters, BN statistics, Adam moments and Adam step
      count bitwise as they were, and moves the others;
    - the CLI with ``--parallel-folds`` (run A's curriculum, 2 folds x 2
      epochs, bf16): one ``mixed_gather`` launch a lockstep step, and run
      A's file names and JSON keys.

    It opens no profiler window (:func:`phase_parallel_times` profiles).
    Returns the ``mixed_gather`` launches of the CLI run."""
    import copy
    from xgan_torch import kernels
    from xgan_torch.cli.train_classifier import main as cls_main
    from xgan_torch.data.pipeline import DeviceStore
    from xgan_torch.kernels.gather import (mixed_gather, mixed_gather_ref,
                                           new_error_flag, raise_if_flagged)
    from xgan_torch.train.classifier import classifier_optimizer, train_step
    from xgan_torch.train.parallel_folds import (FoldAdam, FoldStack,
                                                 fold_view,
                                                 lockstep_train_step)
    dev = torch.device("cuda")
    k, b = PF_K, CLS_B
    real, syn = DeviceStore(train, dev), DeviceStore(synth, dev)
    g = torch.Generator(dev).manual_seed(80)
    launched = 0

    # the fold-batched gather
    sets = [(torch.randint(0, len(real), (k, b), generator=g, device=dev),
             torch.randint(0, len(syn), (k, b), generator=g, device=dev),
             torch.rand((k, b), generator=g, device=dev) < 0.5)
            for _ in range(8)]
    ridx, sidx, mix = sets[0]
    for name, m in (("mixed", mix), ("all real", torch.zeros_like(mix)),
                    ("all synthetic", torch.ones_like(mix))):
        kernels.reset_launch_counts()
        got = mixed_gather(real.images, syn.images, ridx, sidx, m)
        check(kernels.LAUNCHES["mixed_gather"] == 1, dict(kernels.LAUNCHES))
        singles = torch.stack([mixed_gather(real.images, syn.images, ridx[f],
                                            sidx[f], m[f])
                               for f in range(k)])
        check(got.shape == (k, b, SIZE, SIZE, 3)
              and torch.equal(got, mixed_gather_ref(real.images, syn.images,
                                                    ridx, sidx, m))
              and torch.equal(got, singles), f"fold-batched gather {name}")
    bad = ridx.clone()
    bad[3, 7] = len(real)
    try:
        mixed_gather(real.images, syn.images, bad, sidx, mix)
    except IndexError:
        pass
    else:
        raise AssertionError("a bad index in fold 4 did not raise")
    err = new_error_flag(dev)
    big_real, big_syn, big_sets = gather_timing_inputs(
        torch.Generator(dev).manual_seed(81), k, b)

    def in_turn(fn):
        it = itertools.cycle(big_sets)
        return lambda: fn(*next(it))

    fold_ms = time_ms(in_turn(lambda r, s, m: mixed_gather(
        big_real, big_syn, r, s, m, err)), reps=32)
    raise_if_flagged(err)
    single_ms = time_ms(in_turn(lambda r, s, m: [mixed_gather(
        big_real, big_syn, r[f], s[f], m[f], err)
        for f in range(k)]), reps=32)
    plain_ms = time_ms(in_turn(lambda r, s, m: mixed_gather_ref(
        big_real, big_syn, r, s, m)), reps=32)
    where_ms = time_ms(in_turn(lambda r, s, m: torch.where(
        m[..., None, None, None], big_syn[s], big_real[r])), reps=32)
    del big_real, big_syn, big_sets
    nbytes = 2 * k * b * SIZE * SIZE * 3 + k * b * 17
    print(f"fold-batched mixed_gather, k={k}, B={b}, 224 px: bitwise equal "
          f"to its plain version and to {k} single launches (mixed, all "
          f"real, all synthetic), one launch; a bad index in one fold "
          f"raises; {fold_ms:.4f} ms per launch by CUDA events, {k} single "
          f"launches {single_ms:.4f} ms, plain {plain_ms:.4f} ms, torch.where "
          f"{where_ms:.4f} ms (32 index sets over 770 MB of stores, from "
          f"HBM); {nbytes / 1e6:.3f} MB, bound {_bytes_ms(nbytes):.4f} ms "
          f"(bytes) [{smi}]")

    # one f32 lockstep step against the 5 sequential fold steps
    fb = 16
    ridx, sidx, mix = (t[:, :fb].contiguous() for t in sets[1])
    flip = torch.rand((k, fb), generator=g, device=dev) < 0.5
    mask = torch.ones((k, fb), device=dev)
    mask[k - 1, fb - 4:] = 0  # a padded tail in the last fold
    models, names = _lockstep_models(dev, torch.float32, k, 90,
                                     freeze=False)
    init = [copy.deepcopy(m.state_dict()) for m in models]
    draws = dict(mode="mix", ratio=0.5, use_synth=mix, synth_pick=sidx,
                 flip=flip)

    def lockstep():
        for m, sd in zip(models, init):
            m.load_state_dict(sd)
        stack = FoldStack(models, names)
        opt = FoldAdam(stack.trainable, k, 1e-3)
        kernels.reset_launch_counts()
        losses, _, _ = lockstep_train_step(stack, opt, real, syn, ridx, mask,
                                           **draws)
        check(kernels.LAUNCHES["mixed_gather"] == 1, dict(kernels.LAUNCHES))
        w = mask.float()
        loss = (losses * w).sum(1) / w.sum(1)
        return loss, torch.stack([torch.stack([
            fold_view(stack.params[n].grad, k)[f].norm() for n in names])
            for f in range(k)]), (stack, opt)

    def sequential(order=None):
        """The k fold steps, each batch's rows taken in ``order``."""
        out, norms = [], []
        rows = torch.arange(fb, device=dev) if order is None else order
        for f, m in enumerate(models):
            m.load_state_dict(init[f])
            opt = classifier_optimizer(m, 1e-3, freeze_base=False)
            losses, _, _ = train_step(
                m, opt, real, syn, ridx[f][rows], mask=mask[f][rows],
                mode="mix", ratio=0.5, use_synth=mix[f][rows],
                synth_pick=sidx[f][rows], flip=flip[f][rows])
            out.append((losses * mask[f][rows]).sum() / mask[f].sum())
            params = dict(m.named_parameters())
            norms.append(torch.stack([params[n].grad.norm() for n in names]))
        return torch.stack(out), torch.stack(norms)

    def diffs(a, ref):
        return (((a[0] - ref[0]).abs() / (1 + ref[0].abs())).max().item(),
                (a[1] - ref[1]).abs() / ref[1])

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    try:
        seq = sequential()
        lock_loss, lock_norms, (stack, opt) = lockstep()
        orders = torch.Generator(dev).manual_seed(81)
        reordered = [diffs(sequential(torch.randperm(
            fb, generator=orders, device=dev)), seq)[1] for _ in range(2)]
        noisy = []
        for seed in (1, 2):
            with noisy_convs(CGAN_FLOOR_RMS, seed):
                noisy.append(diffs(sequential(), seq)[1])
        floor_draws = torch.stack(reordered + noisy)  # (4, k, tensors)
        torch.backends.cuda.matmul.allow_tf32 = True
        torch.backends.cudnn.allow_tf32 = True
        tf32 = lockstep()[:2]
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cudnn.deterministic = False
    m_err, rel = diffs((lock_loss, lock_norms), seq)
    # a fold's floor is the largest its draws moved any of its tensors:
    # one tensor's own floor from a few draws is too noisy an estimate
    # (against its own, the worst of 805 tensors read 1.38-1.73x)
    own = floor_draws.amax(0)
    floor = own.amax(1, keepdim=True)
    limit = 1e-3 + 2 * floor
    own_ratio = rel / (1e-3 + 2 * own)
    ratio = (rel / limit).max().item()
    f_w, n_w = divmod(int((rel / limit).argmax()), len(names))
    tf_m, tf_rel = diffs(tf32, seq)
    tf_ratio = tf_rel / limit
    print(f"f32 lockstep step (k={k}, B={fb}, --unfreeze, one padded tail) "
          f"vs {k} sequential fold steps on the card: losses max |diff| / "
          f"(1 + |ref|) {m_err:.3g} (tol 1e-4); gradient norms max relative "
          f"diff {rel.max().item():.3g} ({int((rel > 1e-3).sum())} of "
          f"{rel.numel()} tensors over 1e-3); floors (the sequential steps "
          f"on their rows in two other orders and with {CGAN_FLOOR_RMS:g} "
          f"rms noise on every conv output) per fold "
          + ", ".join(f"{v:.3g}" for v in floor.flatten().tolist())
          + f"; held at 1e-3 + 2 floor: {ratio:.3f} of the limit (worst "
          f"fold {f_w + 1} {names[n_w]}); against each tensor's own floor "
          f"(not held): max {own_ratio.max().item():.3f}, over it on "
          f"{int((own_ratio > 1).sum())} tensors")
    print(f"control, the lockstep step with TF32 on: losses {tf_m:.3g}, "
          f"gradient norms {tf_rel.max().item():.3g}, "
          f"{tf_ratio.max().item():.3f} of the limit, over it on "
          f"{int((tf_ratio > 1).sum())} of {tf_ratio.numel()} tensors")
    check(m_err <= 1e-4, "f32 lockstep step: losses differ")
    check(ratio <= 1.0, "f32 lockstep step: gradient norms differ")
    check(tf_ratio.max().item() > 1.0,
          "f32 lockstep check: a TF32 step passes its limits too")

    # the freeze: fold 3 gets an all-zero mask
    frozen = 2
    held = stack.fold_tensors() + opt.state_tensors()
    before = [fold_view(t, k)[frozen].clone() for t in held]
    others = [fold_view(t, k)[0].clone() for t in stack.trainable]
    steps_before = opt.step_count.copy()
    mask2 = torch.ones((k, fb), device=dev)
    mask2[frozen] = 0
    lockstep_train_step(stack, opt, real, syn, ridx, mask2, **draws)
    check(all(torch.equal(fold_view(t, k)[frozen], s)
              for t, s in zip(held, before)), "a frozen fold moved")
    check(not all(torch.equal(fold_view(t, k)[0], s)
                  for t, s in zip(stack.trainable, others)),
          "an active fold did not move")
    want_steps = steps_before + 1
    want_steps[frozen] -= 1
    check(np.array_equal(opt.step_count, want_steps), opt.step_count)
    print(f"freeze: fold {frozen + 1} with an all-zero mask kept its "
          f"{len(held)} parameter, buffer and Adam tensors bitwise and its "
          f"step count at {opt.step_count[frozen]} while the others "
          f"advanced to {opt.step_count[0]}")
    del stack, opt, models, init, held, before, others
    torch.cuda.empty_cache()

    # the CLI: run A's configuration with --parallel-folds
    out = os.path.join(tmp, "parallel")
    argv = ["--data-dir", root, "--synthetic-dir", synth_dir,
            "--model-dir", os.path.join(out, "models"),
            "--results-dir", os.path.join(out, "metrics"),
            "--figures-dir", os.path.join(out, "figures"),
            "--cache-dir", os.path.join(tmp, "cache"), "--workers", "8",
            "--image-size", str(SIZE), "--batch-size", str(CLS_B),
            "--compute-dtype", "bf16", *RUNS["A"], "--parallel-folds"]
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    summary = cls_main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    gathers = kernels.LAUNCHES["mixed_gather"]
    launched += gathers
    folds, epochs = 2, 2
    steps = epochs * math.ceil(N_TRAIN // folds / CLS_B)
    check(gathers == steps, f"--parallel-folds: {gathers} mixed_gather "
          f"launches for {steps} lockstep steps")
    run_a = os.path.join(tmp, "runA")
    for sub in ("metrics", "models", "figures"):
        check(sorted(os.listdir(os.path.join(out, sub)))
              == sorted(os.listdir(os.path.join(run_a, sub))),
              (sub, os.listdir(os.path.join(out, sub))))
    for name in os.listdir(os.path.join(out, "metrics")):
        with open(os.path.join(out, "metrics", name)) as f:
            ours = json.load(f)
        with open(os.path.join(run_a, "metrics", name)) as f:
            theirs = json.load(f)
        check(set(ours) == set(theirs), name)
        if "history" in name:
            check(ours["epoch"] == [1, 2]
                  and ours["synthetic_ratio"] == [0.25, 0.5]
                  and all(math.isfinite(v) for v in ours["train_loss"]),
                  (name, ours))
    check(set(summary["average"]) == METRIC_KEYS, summary)
    print(f"classifier CLI --parallel-folds (run A: curriculum, 2 folds x "
          f"2 epochs, bf16, B={CLS_B}): {wall:.1f} s wall, {gathers} "
          f"mixed_gather launches for {steps} lockstep steps (one a step); "
          f"file names and JSON keys equal to run A's; mean accuracy "
          f"{summary['average']['accuracy']:.4f}")

    return launched


def phase_parallel_times(train, synth, smi: str) -> int:
    """The fold-batched ``mixed_gather``'s device time per launch (k = 5,
    B = 32), and the bf16 lockstep step at k = 5, frozen and
    ``--unfreeze``, beside 5 sequential steps: ms, imgs/s, the device idle
    share of a profiled step, peak memory above the held state. Returns
    the ``mixed_gather`` launches of the timed lockstep steps."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from xgan_torch import kernels
    from xgan_torch.data.pipeline import DeviceStore
    from xgan_torch.kernels.gather import mixed_gather
    from xgan_torch.train.classifier import classifier_optimizer, train_step
    from xgan_torch.train.parallel_folds import (FoldAdam, FoldStack,
                                                 lockstep_train_step)
    dev = torch.device("cuda")
    k, b = PF_K, CLS_B
    real, syn = DeviceStore(train, dev), DeviceStore(synth, dev)
    g = torch.Generator(dev).manual_seed(82)
    launched = 0
    big_real, big_syn, big_sets = gather_timing_inputs(
        torch.Generator(dev).manual_seed(81), k, b)
    sets = itertools.cycle(big_sets)
    fold_us = device_us(lambda: mixed_gather(big_real, big_syn, *next(sets)),
                        calls=32)
    del big_real, big_syn, big_sets, sets
    out_bytes = k * b * SIZE * SIZE * 3
    nbytes = 2 * out_bytes + k * b * 17
    bound_us = _bytes_ms(nbytes) * 1e3
    read_us = _bytes_ms(nbytes - out_bytes) * 1e3
    # below 1 where the output is absorbed by the L2, which writes it back
    # to HBM after the launch: within it only the reads must cross HBM
    print(f"fold-batched mixed_gather, k={k}, B={b}, 224 px: {fold_us:.2f} "
          f"us of device time per launch (profiler; 32 index sets over 770 "
          f"MB of stores, rows read from HBM), bound {bound_us:.2f} us "
          f"(bytes, the output written to HBM): time / bound "
          f"{fold_us / bound_us:.3f}; the {out_bytes / 1e6:.1f} MB output "
          f"fits the 50 MB L2, the reads alone {read_us:.2f} us: time / "
          f"that {fold_us / read_us:.3f} [{smi}]")

    # bf16 lockstep step against 5 sequential steps, frozen and --unfreeze
    idx = torch.randint(0, len(real), (14, k, b), generator=g, device=dev)
    ones = torch.ones((k, b), device=dev)
    host_ones = np.ones((k, b), np.float32)
    for freeze in (True, False):
        tag = "frozen" if freeze else "--unfreeze"
        models, names = _lockstep_models(dev, torch.bfloat16, k, 95, freeze)
        opts = [classifier_optimizer(m, 1e-3, freeze_base=freeze)
                for m in models]
        stack = FoldStack(models, names)
        fopt = FoldAdam(stack.trainable, k, 1e-3)

        def lock(i):
            return lockstep_train_step(
                stack, fopt, real, syn, idx[i], ones, host_mask=host_ones,
                mode="mix", dtype=torch.bfloat16, ratio=0.5, generator=g)

        def seq(i):
            for f in range(k):
                train_step(models[f], opts[f], real, syn, idx[i, f],
                           mode="mix", dtype=torch.bfloat16, ratio=0.5,
                           generator=g)

        res = {}
        for name, fn in (("lockstep", lock), ("sequential", seq)):
            for i in range(3):
                fn(i)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            held_b = torch.cuda.memory_allocated()
            kernels.reset_launch_counts()
            t0 = time.perf_counter()
            for i in range(3, 13):
                fn(i)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) / 10 * 1e3
            peak = torch.cuda.max_memory_allocated() - held_b
            check(kernels.LAUNCHES["mixed_gather"]
                  == (10 if name == "lockstep" else 10 * k),
                  (name, dict(kernels.LAUNCHES)))
            if name == "lockstep":
                launched += 10
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                fn(13)
                torch.cuda.synchronize()
            busy = sum(e.device_time for e in prof.events()
                       if e.device_type == DeviceType.CUDA) / 1e3
            res[name] = ms
            print(f"{name} step, k={k} folds (mix, {tag}, bf16, B={b} a "
                  f"fold, 224 px): {ms:.3f} ms per step of all {k} folds "
                  f"(mean of 10 warm), {k * b / ms * 1e3:.1f} imgs/s, "
                  f"{busy:.3f} ms device time in one profiled step, idle "
                  f"share ~{1 - busy / ms:.3f}; peak memory "
                  f"{peak / 2**30:.3f} GiB above the "
                  f"{held_b / 2**30:.3f} GiB held [{smi}]")
        print(f"lockstep / sequential ({tag}): "
              f"{res['lockstep'] / res['sequential']:.3f}")
        del models, opts, stack, fopt
        torch.cuda.empty_cache()
    return launched


# ---- the inference surface: msgpack, export, predict, serve, data_loader --

SERVE_N = 64  # requests per concurrency level
LOADER_MODES = ("basic", "kfold", "augmented", "kfold_augmented",
                "phased_kfold")
# mixed_gather launches of each data_loader mode: one per mixed batch
LOADER_GATHERS = {"augmented": 1, "kfold_augmented": 1, "phased_kfold": 3}


def random_flax(like, rng, path=()):
    """Seeded random leaves for a flax template of
    ``xgan_torch.io_.checkpoint.flax_like``: kernels N(0, 2/fan) (unit
    gain; a k4s2 ConvT's fan is 4 Cin, the first ConvT's Cin), random BN
    scale, bias and running statistics, biases N(0, 0.1²), embeddings
    N(0, 1)."""
    if isinstance(like, dict):
        return {k: random_flax(v, rng, path + (k,)) for k, v in like.items()}
    shape, name = like.shape, path[-1]
    parent = path[-2] if len(path) > 1 else ""
    if name == "kernel":
        fan = (shape[2] * (1 if parent == "ConvTranspose_0" else 4)
               if parent.startswith("ConvTranspose")
               else int(np.prod(shape[:-1])))
        x = rng.normal(size=shape) * math.sqrt(2.0 / fan)
    elif name == "scale":
        x = 1 + 0.1 * rng.normal(size=shape)
    elif name in ("bias", "mean"):
        x = 0.1 * rng.normal(size=shape)
    elif name == "var":
        x = 0.5 + rng.random(shape)
    else:
        x = rng.normal(size=shape)
    return x.astype(np.float32)


def captured(fn, *args):
    """``fn(*args)``'s result, its printed output (also echoed) and its
    ``SystemExit`` code (None when it returned)."""
    import io
    buf, code, result = io.StringIO(), None, None
    with contextlib.redirect_stdout(buf):
        try:
            result = fn(*args)
        except SystemExit as e:
            code = e.code
    print(buf.getvalue(), end="")
    return result, buf.getvalue(), code


def phase_msgpack(tmp: str, root: str) -> tuple[dict, int]:
    """A G-224 (fg 64, latent 100) and a ResNet-50 with seeded random
    weights, each written by the port's flax-format writer and as a
    ``.pth`` twin; the sampler CLI on both generators (128 PNGs, bf16)
    and the predict CLI on both classifiers (the tree's test PNGs) must
    give equal outputs bitwise. Returns the checkpoint paths and the
    sampler runs' ConvT launches (5 a batch, tensor-core route)."""
    from xgan_torch import kernels
    from xgan_torch.cli import generate_synthetic, predict
    from xgan_torch.io_.checkpoint import flax_like, state_dict_from_flax
    from xgan_torch.io_.msgpack import msgpack_serialize
    from xgan_torch.models.dcgan import Generator
    from xgan_torch.models.resnet import ResNet50
    from xgan_torch.native.png import decode_png
    rng = np.random.default_rng(12)
    paths = {}
    for name, model in (("g", Generator(LATENT, 3, FG, SIZE)),
                        ("r", ResNet50(2))):
        tree = random_flax(flax_like(model), rng)
        msg, pth = (os.path.join(tmp, f"{name}{ext}")
                    for ext in (".msgpack", ".pth"))
        with open(msg, "wb") as f:
            f.write(msgpack_serialize(tree))
        torch.save(state_dict_from_flax(model, tree), pth)
        paths[name] = {"msgpack": msg, "pth": pth}
    n = 2 * B
    imgs = {}
    kernels.reset_launch_counts()
    for fmt, path in paths["g"].items():
        out = os.path.join(tmp, f"sampled_{fmt}")
        generate_synthetic.main([
            "--model-path", path, "--output-dir", out,
            "--num-images", str(n), "--latent-dim", str(LATENT),
            "--feature-maps-g", str(FG), "--image-size", str(SIZE),
            "--batch-size", str(B), "--compute-dtype", "bf16"])
        imgs[fmt] = np.stack([decode_png(os.path.join(out, f))
                              for f in sorted(os.listdir(out))])
    launches = kernels.LAUNCHES["convt4x4s2_fused"]
    print(f"msgpack: sampler launches {dict(kernels.LAUNCHES)}")
    check(imgs["msgpack"].shape == (n, SIZE, SIZE, 3)
          and np.array_equal(imgs["msgpack"], imgs["pth"])
          and imgs["pth"].std() > 10,
          "the .msgpack generator's PNGs differ from its .pth twin's")
    want = 2 * 5 * math.ceil(n / B)
    check(launches == want and on_new_designs(kernels.LAUNCHES, want),
          (dict(kernels.LAUNCHES), want))
    preds = {}
    for fmt, path in paths["r"].items():
        out = os.path.join(tmp, f"predictions_{fmt}.json")
        predict.main(["--model-path", path, "--input-dir",
                      os.path.join(root, "Test"), "--output", out,
                      "--image-size", str(SIZE), "--batch-size", str(B),
                      "--compute-dtype", "bf16"])
        with open(out) as f:
            preds[fmt] = json.load(f)["predictions"]
    check(len(preds["pth"]) == N_TEST and preds["msgpack"] == preds["pth"],
          "the .msgpack classifier's predictions differ from its .pth's")
    print(f"msgpack: {n} sampled PNGs and {N_TEST} predictions equal to "
          "the .pth twins' bitwise")
    return paths, launches


EXPORTS = (("gan", "bf16", "none"), ("gan", "bf16", "int8"),
           ("gan", "f32", "none"), ("classifier", "bf16", "none"),
           ("classifier", "bf16", "int8"), ("classifier", "f32", "none"))


def phase_export(tmp: str, paths: dict) -> tuple[dict, int]:
    """``export_model`` of the G-224 and the ResNet-50 from their
    ``.msgpack``: bf16 and int8 verified against the live model, f32 for
    its size. Prints sizes and wall times; the int8 artifacts must be at
    most 0.35 of the f32 ones. Measures what a served batch's size does
    to a row (the G artifact at 1, 2 and 4 rows against 8) and what the
    int8 G's per-call dequantize and repack costs (B = 64). A CPU-exported
    artifact must be refused on the card. Returns the artifact paths and
    the verifications' ConvT launches (5 a G verified)."""
    from xgan_torch import kernels
    from xgan_torch.cli import export_model, generate_synthetic
    from xgan_torch.io_.export import load_exported
    arts, sizes = {}, {}
    kernels.reset_launch_counts()
    for kind, dt, q in EXPORTS:
        out = os.path.join(tmp, f"{kind}_{dt}_{q}.pt2")
        src = paths["g" if kind == "gan" else "r"]["msgpack"]
        argv = ["--kind", kind, "--model-path", src,
                "--output", out, "--image-size", str(SIZE),
                "--latent-dim", str(LATENT), "--feature-maps-g", str(FG),
                "--compute-dtype", dt, "--quantize", q]
        stats = export_model.main(argv + ["--skip-verify"] * (dt == "f32"))
        check(stats["verified"] is (None if dt == "f32" else True), stats)
        sizes[(kind, dt, q)] = os.path.getsize(out)
        arts[(kind, dt, q)] = out
        print(f"export {kind} {dt} quantize={q}: {sizes[(kind, dt, q)]} "
              f"bytes, {stats['export_s']:.3f} s export (trace + save), "
              f"verified {stats['verified']}")
    launches = kernels.LAUNCHES["convt4x4s2_fused"]
    check(launches == 10 and on_new_designs(kernels.LAUNCHES, 10),
          dict(kernels.LAUNCHES))
    for kind in ("gan", "classifier"):
        ratio = sizes[(kind, "bf16", "int8")] / sizes[(kind, "f32", "none")]
        bf16 = sizes[(kind, "bf16", "none")] / sizes[(kind, "f32", "none")]
        print(f"export {kind}: int8 / f32 size {ratio:.3f}, bf16 / f32 "
              f"{bf16:.3f}")
        check(ratio <= 0.35, f"{kind}: int8 artifact not smaller")
    art = load_exported(arts[("gan", "bf16", "none")], "cuda")
    q8 = load_exported(arts[("gan", "bf16", "int8")], "cuda")
    check(art.kernel_ops == ["xgan_torch.convt4x4s2_band.default",
                             "xgan_torch.convt4x4s2_wgmma.default"],
          art.kernel_ops)
    z = torch.randn(B, LATENT, generator=torch.Generator().manual_seed(5))
    z = z.to("cuda")
    full = art.call(z[:8])
    diffs = {b: (art.call(z[:b]).int() - full[:b].int()).abs().max().item()
             for b in (1, 2, 4)}
    print(f"export: G artifact rows at batch 1, 2, 4 against batch 8, max "
          f"|diff| in u8 levels {diffs} (the server runs every generator "
          "dispatch at --max-batch rows)")
    ms = {name: time_ms(lambda a=a: a.call(z), reps=10)
          for name, a in (("bf16", art), ("int8", q8))}
    print(f"export: G artifact call at B = {B}: bf16 {ms['bf16']:.4f} ms, "
          f"int8 {ms['int8']:.4f} ms (dequantize + repack each call: "
          f"{ms['int8'] - ms['bf16']:.4f} ms)")
    # an artifact exported on the CPU is refused here
    cpu_pth = os.path.join(tmp, "g32.pth")
    cpu_art = os.path.join(tmp, "g32_cpu.pt2")
    from xgan_torch.models.dcgan import Generator
    torch.save(Generator(16, 3, 8, 64).state_dict(), cpu_pth)
    export_model.main(["--cpu", "--kind", "gan", "--model-path", cpu_pth,
                       "--output", cpu_art, "--image-size", "64",
                       "--latent-dim", "16", "--feature-maps-g", "8"])
    _, out, code = captured(generate_synthetic.main, [
        "--model-path", cpu_art, "--output-dir",
        os.path.join(tmp, "refused"), "--num-images", "4"])
    check(code == 1 and "Error loading generator artifact" in out
          and "exported on cpu" in out, (code, out))
    return arts, launches


def phase_artifact_profile(train, smi: str, run: int):
    """One call of the bf16 G-224 artifact at B = 64 under
    ``torch.profiler``: its 5 ConvT kernels, which the Python counts do
    not see inside a program. Returns their number."""
    from torch.autograd import DeviceType
    from xgan_torch.io_.export import load_exported
    art = load_exported(os.path.join(CHILD_TMP, "gan_bf16_none.pt2"), "cuda")
    z = torch.randn(B, LATENT, device="cuda")
    events, _ = warm_profile(lambda: art.call(z), lambda: art.call(z))
    ours = [e for e in events if e.device_type == DeviceType.CUDA
            and "convt4x4s2" in e.name]
    print(f"artifact profile: {len(ours)} convt4x4s2 kernels in one call "
          f"({sum(e.device_time for e in ours) / 1e3:.3f} ms device)")
    check(len(ours) == 5 and all(WGMMA_KERNEL in e.name
                                 or BAND_KERNEL in e.name for e in ours),
          [e.name for e in ours])
    return len(ours)


def phase_predict(tmp: str, root: str, paths: dict, arts: dict) -> None:
    """The predict CLI over the tree's 512 train PNGs (256 px, B = 64,
    bf16) from the ``.pth`` and from the bf16 ``.pt2``: imgs/s (second of
    two runs) and the host decode's share; their probabilities within
    export_model's bf16 tolerance (2e-2)."""
    from xgan_torch.cli import predict
    preds = {}
    for fmt, path in (("pth", paths["r"]["pth"]),
                      ("pt2", arts[("classifier", "bf16", "none")])):
        out = os.path.join(tmp, f"predict_{fmt}.json")
        argv = ["--model-path", path, "--input-dir",
                os.path.join(root, "Training", "Images"), "--output", out,
                "--image-size", str(SIZE), "--batch-size", str(B),
                "--compute-dtype", "bf16"]
        runs = [predict.main(argv) for _ in range(2)]
        st = runs[-1]
        print(f"predict {fmt}: {st['num_images']} PNGs, "
              f"{st['imgs_per_sec']:.1f} imgs/s (first run "
              f"{runs[0]['imgs_per_sec']:.1f}), wall {st['wall_s']:.3f} s, "
              f"host decode {st['decode_s']:.3f} s "
              f"({st['decode_s'] / st['wall_s']:.3f} of the wall)")
        with open(out) as f:
            preds[fmt] = json.load(f)["predictions"]
    check(len(preds["pt2"]) == N_TRAIN, len(preds["pt2"]))
    d = max(abs(a["prob_positive"] - b["prob_positive"])
            for a, b in zip(preds["pth"], preds["pt2"]))
    print(f"predict: .pt2 against .pth, max |prob diff| {d:.3g}")
    check(d <= 2e-2, d)


def serve_processes(*model_paths):
    """The port's server on each of ``model_paths``, each in a process of
    its own on an ephemeral port, all started at once; returns [(process,
    port)] once every one reports ready (a server that fails kills
    them all)."""
    import queue
    procs, ready = [], []
    try:
        for path in model_paths:
            proc = subprocess.Popen(
                [sys.executable, "-u", "-m", "xgan_torch.cli.serve",
                 "--model-path", path, "--port", "0"],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                cwd=HERE)
            lines = queue.Queue()
            threading.Thread(target=lambda p=proc, q=lines:
                             [q.put(ln) for ln in p.stdout],
                             daemon=True).start()
            procs.append((proc, lines))
        deadline = time.time() + 300
        for proc, lines in procs:
            seen = []
            while True:
                check(time.time() < deadline,
                      "server not ready in 300 s:\n" + "".join(seen))
                try:
                    line = lines.get(timeout=5)
                except queue.Empty:
                    check(proc.poll() is None,
                          "server died:\n" + "".join(seen))
                    continue
                seen.append(line)
                if line.startswith("Serving"):
                    ready.append((proc, int(line.rsplit(":", 1)[-1])))
                    break
        return ready
    finally:
        if len(ready) < len(procs):
            for proc, _ in procs:
                proc.kill()


def http(port: int, path: str, data: bytes | None = None):
    """(status, body) of one request to the local server."""
    import urllib.error
    import urllib.request
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=data,
                                 method="POST" if data is not None else "GET")
    try:
        with urllib.request.urlopen(req, timeout=120) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def load_run(port: int, path: str, bodies: list, concurrency: int):
    """Send ``bodies`` at ``concurrency``; returns (bodies of the answers,
    p50 and p99 latency in ms, requests/s)."""
    from concurrent.futures import ThreadPoolExecutor

    def one(body):
        t0 = time.perf_counter()
        status, out = http(port, path, body)
        check(status == 200, (status, out[:200]))
        return out, (time.perf_counter() - t0) * 1e3

    t0 = time.perf_counter()
    with ThreadPoolExecutor(concurrency) as pool:
        res = list(pool.map(one, bodies))
    wall = time.perf_counter() - t0
    lat = sorted(ms for _, ms in res)
    p = [lat[min(len(lat) - 1, int(q * len(lat)))] for q in (0.5, 0.99)]
    return [out for out, _ in res], p[0], p[1], len(bodies) / wall


def occupancy(port: int) -> dict:
    """{rows: dispatches} from ``/metrics``."""
    _, text = http(port, "/metrics")
    return {int(m.group(1)): int(m.group(2)) for m in re.finditer(
        r'xgan_batch_occupancy\{rows="(\d+)"\} (\d+)', text.decode())}


def drain(proc, port: int) -> None:
    """SIGTERM with one request in flight (its body held back): /healthz
    turns 503 draining, a new POST gets 503, the held request still gets
    its 200, and the server exits 0."""
    import signal
    import socket
    body = json.dumps({"seed": 3}).encode()
    s = socket.create_connection(("127.0.0.1", port), timeout=60)
    s.sendall(b"POST /generate HTTP/1.1\r\nHost: x\r\nConnection: close\r\n"
              + f"Content-Length: {len(body)}\r\n\r\n".encode() + body[:1])
    time.sleep(1.0)
    proc.send_signal(signal.SIGTERM)
    deadline = time.time() + 30
    while time.time() < deadline and http(port, "/healthz")[0] != 503:
        time.sleep(0.05)
    status, out = http(port, "/healthz")
    check(status == 503 and json.loads(out).get("draining"), out)
    status, out = http(port, "/generate", json.dumps({"seed": 1}).encode())
    check(status == 503 and b"draining" in out, (status, out))
    s.sendall(body[1:])
    reply = b""
    while chunk := s.recv(65536):
        reply += chunk
    s.close()
    head, _, payload = reply.partition(b"\r\n\r\n")
    check(b" 200 " in head.split(b"\r\n", 1)[0]
          and payload.startswith(PNG_SIG), head[:100])
    check(proc.wait(timeout=60) == 0, "the drained server did not exit 0")


def stop(proc) -> None:
    import signal
    proc.send_signal(signal.SIGTERM)
    check(proc.wait(timeout=60) == 0, "the server did not exit 0")


def phase_serve(tmp: str, root: str, arts: dict, smi: str) -> None:
    """The server on the bf16 and int8 G artifacts and on the bf16
    classifier artifact, the three started at once and measured in turn:
    64 requests at concurrency 1 and 8 each (p50, p99, requests/s, the
    dispatch occupancy), every /generate answer at concurrency 8 bitwise
    the one at concurrency 1, and the SIGTERM drain."""
    from xgan_torch.native.png import decode_png_bytes
    seeds = [json.dumps({"seed": s}).encode() for s in range(SERVE_N)]
    servers = serve_processes(arts[("gan", "bf16", "none")],
                              arts[("gan", "bf16", "int8")],
                              arts[("classifier", "bf16", "none")])
    try:
        for q, (proc, port) in zip(("none", "int8"), servers):
            got = {}
            for conc in (1, 8):
                outs, p50, p99, rps = load_run(port, "/generate", seeds, conc)
                got[conc] = [decode_png_bytes(o) for o in outs]
                print(f"serve /generate bf16 quantize={q}, concurrency "
                      f"{conc}: p50 {p50:.3f} ms, p99 {p99:.3f} ms, "
                      f"{rps:.1f} requests/s; occupancy {occupancy(port)} "
                      f"[{smi}]")
            check(got[1][0].shape == (SIZE, SIZE, 3), got[1][0].shape)
            check(all(np.array_equal(a, b) for a, b in zip(got[1], got[8])),
                  "a batched /generate differs from the unbatched one")
            if q == "none":
                drain(proc, port)
            else:
                stop(proc)
        test = sorted(os.listdir(os.path.join(root, "Test")))[:SERVE_N]
        bodies = []
        for name in test:
            with open(os.path.join(root, "Test", name), "rb") as f:
                bodies.append(f.read())
        proc, port = servers[2]
        for conc in (1, 8):
            outs, p50, p99, rps = load_run(port, "/predict", bodies, conc)
            probs = [json.loads(o)["prob_positive"] for o in outs]
            check(all(0 <= p <= 1 for p in probs), probs[:4])
            print(f"serve /predict bf16, concurrency {conc}: p50 "
                  f"{p50:.3f} ms, p99 {p99:.3f} ms, {rps:.1f} requests/s; "
                  f"occupancy {occupancy(port)} [{smi}]")
        stop(proc)
    finally:
        for proc, _ in servers:
            if proc.poll() is None:
                proc.kill()


def phase_data_loader(tmp: str, root: str, synth_dir: str) -> int:
    """The data-layer self-test CLI in every mode on the tree and the
    sampler's PNGs (224 px): the batch lines, the wall time of each mode
    (the first builds the cached stores), and one ``mixed_gather`` launch
    per mixed batch (3 in ``phased_kfold``). Returns the launches."""
    from xgan_torch import kernels
    from xgan_torch.cli import data_loader
    total = 0
    for mode in LOADER_MODES:
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        _, out, code = captured(data_loader.main, [
            "--data-dir", root, "--synthetic-dir", synth_dir,
            "--cache-dir", os.path.join(tmp, "loader_cache"),
            "--image-size", str(SIZE), "--test-mode", mode])
        dt = time.perf_counter() - t0
        n = kernels.LAUNCHES["mixed_gather"]
        print(f"data_loader {mode}: {dt:.3f} s, mixed_gather launches {n}")
        check(code is None and "Error" not in out
              and out.rstrip().endswith("Data pipeline self-test finished.")
              and f"images (4, {SIZE}, {SIZE}, 3) float32" in out, out)
        check(n == LOADER_GATHERS.get(mode, 0), (mode, n))
        total += n
    return total


# ---- data parallelism across ranks (A14, part 1) --------------------------

LAUNCH_KEYS = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR",
               "MASTER_PORT")
# a CLI's main in a process of its own, with deterministic cuDNN (the CLIs
# turn TF32 off for f32), printing its kernel launches as its last line
CLI_LAUNCHER = (
    "import importlib, json, sys, torch\n"
    "torch.backends.cudnn.deterministic = True\n"
    "from xgan_torch import kernels\n"
    "importlib.import_module('xgan_torch.cli.' + sys.argv[1])"
    ".main(sys.argv[2:])\n"
    "print('LAUNCHES ' + json.dumps(dict(kernels.LAUNCHES)))\n")


def free_ports(n: int) -> list:
    """``n`` distinct free local ports (their sockets held together)."""
    import socket
    with contextlib.ExitStack() as stack:
        socks = [stack.enter_context(socket.socket()) for _ in range(n)]
        for s in socks:
            s.bind(("127.0.0.1", 0))
        return [s.getsockname()[1] for s in socks]


def free_port() -> int:
    return free_ports(1)[0]


def launch_env(rank: int, world: int, local_rank: int, port: int) -> dict:
    """The environment ``torchrun`` gives a rank on one host."""
    return {**os.environ, "RANK": str(rank), "WORLD_SIZE": str(world),
            "LOCAL_RANK": str(local_rank), "MASTER_ADDR": "127.0.0.1",
            "MASTER_PORT": str(port)}


def dp_cli(module: str, argv: list, port: int | None):
    """Starts ``xgan_torch.cli.<module>`` in a process of its own, under a
    ``torchrun`` environment of one rank (``port``: the NCCL group at
    world 1 on that port) or none; :func:`dp_cli_result` reads it."""
    env = {k: v for k, v in os.environ.items() if k not in LAUNCH_KEYS}
    if port is not None:
        env = launch_env(0, 1, 0, port)
    return subprocess.Popen([sys.executable, "-u", "-c", CLI_LAUNCHER,
                             module, *argv], stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True, cwd=HERE,
                            env=env)


def dp_cli_result(module: str, proc):
    """The output and the kernel launches of a :func:`dp_cli` process."""
    try:
        out = proc.communicate(timeout=600)[0]
    finally:
        if proc.poll() is None:
            proc.kill()
    check(proc.returncode == 0, f"{module}: exit {proc.returncode}\n"
          + out[-3000:])
    last = out.strip().splitlines()[-1]
    check(last.startswith("LAUNCHES "), last)
    return out, json.loads(last[len("LAUNCHES "):])


def f32_close(got, want) -> float:
    """Worst |got - want| / (1 + |want|) over two equal-length number
    lists (the f32 step limit, 1e-4, is checked by the caller)."""
    check(len(got) == len(want), (len(got), len(want)))
    return max((abs(a - b) / (1 + abs(b)) for a, b in zip(got, want)),
               default=0.0)


GAN_ITER_KEYS = ("G_losses_iter", "D_losses_iter", "D_x_iter",
                 "D_G_z1_iter", "D_G_z2_iter")


def dp_cli_processes(tmp: str, root: str, synth_dir: str) -> dict:
    """(a)'s CLI processes, all started at once (``phase_dp_cli``'s four
    and ``phase_dp_cli_loops``' ten): (run, module) -> process, the runs
    ``plain`` and ``nccl`` (the DCGAN and classifier) and ``plain2`` and
    ``nccl2`` (A14 part 2). They share the card: each is f32 with TF32
    off and deterministic cuDNN, and none is timed."""
    procs = {}
    ports = iter(free_ports(2 + len(DP_LOOP_RUNS)))
    for name, launched in (("plain", False), ("nccl", True)):
        extra = ["--shard-store"] if launched else []
        gdir = os.path.join(tmp, "dp", f"gan_{name}")
        procs[name, "train_gan"] = dp_cli("train_gan", gan_cli_argv(
            tmp, root, gdir, "--epochs", "2", "--limit-batches", "2",
            "--compute-dtype", "f32", *extra),
            next(ports) if launched else None)
        cdir = os.path.join(tmp, "dp", f"clf_{name}")
        procs[name, "train_classifier"] = dp_cli("train_classifier", [
            "--data-dir", root, "--synthetic-dir", synth_dir,
            "--use-synthetic", "--k-folds", "1", "--epochs", "1",
            "--limit-batches", "2", "--model-dir", os.path.join(cdir, "m"),
            "--results-dir", os.path.join(cdir, "metrics"),
            "--figures-dir", os.path.join(cdir, "figures"),
            "--cache-dir", os.path.join(tmp, "cache"), "--workers", "8",
            "--image-size", str(SIZE), "--batch-size", str(CLS_B),
            "--compute-dtype", "f32", *extra],
            next(ports) if launched else None)
        argv = dp_loop_argv(tmp, root, synth_dir, name, launched)
        for module in DP_LOOP_RUNS:
            procs[f"{name}2", module] = dp_cli(
                module, argv[module], next(ports) if launched else None)
    return procs


# the launches of phase_dp_cli's runs with no group, which phase_a14_4
# holds its TP CLIs against
PLAIN_LAUNCHES = {}


def phase_dp_cli(tmp: str, root: str, synth_dir: str, smi: str,
                 procs: dict):
    """(a) The DCGAN and classifier CLIs under a ``torchrun`` environment
    of one rank on NCCL, with ``--shard-store`` (a no-op at world 1),
    against the same CLI with no process group, f32 with TF32 off and
    deterministic cuDNN (``procs``, :func:`dp_cli_processes`): the DCGAN at full
    width (B = 128, 2 epochs of 2 steps), the classifier in the augmented
    mode (ResNet-50, B = 32, one run of 2 steps). The DCGAN's first step within 1e-4 * (1 + |ref|)
    and every step within 5e-2; the classifier's history and metrics
    within 1e-4 * (1 + |ref|); the same files, the same launches. Returns
    the launched runs' (ConvT, mixed_gather) launches."""
    out = {}
    results = {key: dp_cli_result(key[1], procs.pop(key))
               for key in [k for k in procs if k[0] in ("plain", "nccl")]}
    for name, launched in (("plain", False), ("nccl", True)):
        gdir = os.path.join(tmp, "dp", f"gan_{name}")
        cdir = os.path.join(tmp, "dp", f"clf_{name}")
        text, gl = results[name, "train_gan"]
        ctext, cl = results[name, "train_classifier"]
        check(("rank 0 of 1" in text and "rank 0 of 1" in ctext)
              or not launched, "the launched runs did not join a group")
        with open(os.path.join(gdir, "metrics",
                               "gan_training_history.json")) as f:
            hist = json.load(f)
        with open(os.path.join(cdir, "metrics",
                               "augmented_final_metrics.json")) as f:
            metrics = json.load(f)["metrics"]
        with open(os.path.join(cdir, "metrics",
                               "augmented_training_history.json")) as f:
            chist = json.load(f)
        sheets = len(os.listdir(os.path.join(gdir, "results",
                                             "gan_images")))
        check(gl.get("convt4x4s2_fused", 0) == 5 * (4 + sheets)
              and cl.get("mixed_gather", 0) == 2, (name, gl, cl, sheets))
        out[name] = (hist, metrics, chist, gl, cl,
                     sorted(os.listdir(os.path.join(gdir, "models", "gan"))))
    (h0, m0, c0, g0, l0, f0), (h1, m1, c1, g1, l1, f1) = \
        out["plain"], out["nccl"]
    PLAIN_LAUNCHES.update(train_gan=g0, train_classifier=l0)
    check(f0 == f1 and g0 == g1 and l0 == l1, (f0, f1, g0, g1, l0, l1))
    per_step = [f32_close([h1[k][t] for k in GAN_ITER_KEYS],
                          [h0[k][t] for k in GAN_ITER_KEYS])
                for t in range(len(h0["G_losses_iter"]))]
    # the first step is the f32 step limit's like-for-like; later steps
    # start from parameters that Adam moved by up to lr where a gradient
    # is rounding noise (tests/test_torch_port_gan_step.py's envelope)
    check(per_step[0] <= 1e-4 and max(per_step) <= 5e-2, per_step)
    print("dp CLIs: DCGAN history per step, worst |a-b|/(1+|b|) of the 5 "
          "metrics: " + ", ".join(f"{v:.3g}" for v in per_step)
          + " (limits: step 1 1e-4, all 5e-2)")
    worst = {
        "classifier metrics": f32_close([m1[k] for k in sorted(m0)],
                                        [m0[k] for k in sorted(m0)]),
        "classifier history": max(f32_close(c1[k], c0[k]) for k in c0)}
    check(all(v <= 1e-4 for v in worst.values()), worst)
    print(f"dp CLIs, world-1 NCCL with --shard-store against no group (f32, "
          f"TF32 off, deterministic cuDNN): worst |a-b|/(1+|b|) "
          + ", ".join(f"{k} {v:.3g}" for k, v in worst.items())
          + f" (limit 1e-4); launches {g1} (DCGAN) {l1} (classifier) "
          f"[{smi}]")
    return g1["convt4x4s2_fused"], l1["mixed_gather"]


def family_cli_argv(tmp: str, root: str, out: str, b: int, fm: int,
                    *extra) -> list:
    """The WGAN-GP or CGAN CLI at full width on the RSNA tree, f32, 1
    epoch of 2 steps, one sample sheet."""
    return ["--data-dir", root, "--model-dir", os.path.join(out, "models"),
            "--output-dir", os.path.join(out, "results"),
            "--results-dir", os.path.join(out, "metrics"),
            "--figures-dir", os.path.join(out, "figures"),
            "--cache-dir", os.path.join(tmp, "cache"), "--workers", "8",
            "--image-size", str(SIZE), "--feature-maps-g", str(fm),
            "--feature-maps-d", str(fm), "--latent-dim", str(LATENT),
            "--batch-size", str(b), "--epochs", "1", "--limit-batches", "2",
            "--save-interval", "1000", "--compute-dtype", "f32", *extra]


DP_LOOP_RUNS = ("train_wggan", "train_cgan", "train_gan", "train_classifier",
                "generate_synthetic")


def dp_loop_argv(tmp: str, root: str, synth_dir: str, name: str,
                 launched: bool) -> dict:
    """``phase_dp_cli_loops``' runs: module -> its argv, into
    ``dp2/<name>``; the sampler on ``phase_gan``'s generator."""
    extra = ["--shard-store"] if launched else []
    d = os.path.join(tmp, "dp2", name)
    pth = os.path.join(tmp, "gan", "models", "gan", "generator_final.pth")
    return {
        "train_wggan": family_cli_argv(
            tmp, root, os.path.join(d, "wgan"), WGAN_B, FG,
            "--critic-iters", str(WGAN_CRITIC), *extra),
        "train_cgan": family_cli_argv(
            tmp, root, os.path.join(d, "cgan"), CGAN_B, CGAN_FM, *extra),
        "train_gan": gan_cli_argv(
            tmp, root, os.path.join(d, "gan"), "--epochs", "1",
            "--limit-batches", "2", "--compute-dtype", "f32",
            "--grad-accum", "2", *extra),
        "train_classifier": [
            "--data-dir", root, "--synthetic-dir", synth_dir,
            "--use-synthetic", "--k-folds", "1", "--epochs", "1",
            "--limit-batches", "2",
            "--model-dir", os.path.join(d, "clf", "m"),
            "--results-dir", os.path.join(d, "clf", "metrics"),
            "--figures-dir", os.path.join(d, "clf", "figures"),
            "--cache-dir", os.path.join(tmp, "cache"), "--workers", "8",
            "--image-size", str(SIZE), "--batch-size", str(CLS_B),
            "--compute-dtype", "f32", "--grad-accum", "2", "--remat",
            *extra],
        "generate_synthetic": [
            "--model-path", pth, "--output-dir",
            os.path.join(d, "synthetic"), "--num-images", "100",
            "--latent-dim", str(LATENT), "--feature-maps-g", str(FG),
            "--image-size", str(SIZE), "--batch-size", str(B),
            "--compute-dtype", "f32"]}


def phase_dp_cli_loops(tmp: str, root: str, synth_dir: str, smi: str,
                       procs: dict):
    """(a), A14 part 2: under a world-1 NCCL ``torchrun`` environment with
    ``--shard-store`` against no group, f32 with TF32 off and
    deterministic cuDNN, ten processes: the WGAN-GP CLI (224
    px, B = 64, fg = fd = 64, 5 critic updates, 2 steps), the CGAN CLI
    (224 px, B = 32, fg = fd = 32, random VGG16, 2 steps), the DCGAN CLI
    with ``--grad-accum 2`` (B = 128, 2 steps), the classifier CLI with
    ``--grad-accum 2 --remat`` (ResNet-50, augmented, B = 32, 2 steps),
    and the DCGAN sampler CLI on ``phase_gan``'s generator (100 PNGs,
    batch 64), started with ``phase_dp_cli``'s (``procs``). The histories: the first step within 1e-4 * (1 + |ref|)
    (the CGAN's too: the launched run's BN combines its moments by Chan's
    formula in float64, where the one-pass variance it took before parted
    from the plain run's ``F.batch_norm`` by 2.5e-4 at the reference
    init's far-from-zero channel means, ROADMAP C10), every step within
    5e-2 (the classifier's within 1e-4); the sampler's files byte-equal;
    the same files and launches. Returns the launched runs' (ConvT,
    mixed_gather) launches."""
    res = {(key[0][:-1], key[1]): dp_cli_result(key[1], procs.pop(key))
           for key in [k for k in procs if k[0] in ("plain2", "nccl2")]}
    dirs = {n: os.path.join(tmp, "dp2", n) for n in ("plain", "nccl")}

    def load(name, *path):
        with open(os.path.join(dirs[name], *path)) as f:
            return json.load(f)

    def files(name, sub):
        top = os.path.join(dirs[name], sub)
        return sorted(os.path.relpath(os.path.join(p, f), top)
                      for p, _, fs in os.walk(top) for f in fs)

    worst = {}
    for module, sub, hist, keys in (
            ("train_wggan", "wgan", "wgan_training_history.json",
             ("D_losses", "G_losses")),
            ("train_cgan", "cgan", "cgan_training_history.json",
             GAN_ITER_KEYS),
            ("train_gan", "gan", "gan_training_history.json",
             GAN_ITER_KEYS)):
        h0, h1 = (load(n, sub, "metrics", hist) for n in ("plain", "nccl"))
        check(files("plain", sub) == files("nccl", sub)
              and res["plain", module][1] == res["nccl", module][1],
              (module, res["plain", module][1], res["nccl", module][1]))
        check("rank 0 of 1" in res["nccl", module][0], module)
        per = history_steps_close(h1, h0, keys)
        check(len(per) == 2 and per[0] <= 1e-4 and max(per) <= 5e-2,
              (module, per))
        worst[module] = per
    launches = {m: res["nccl", m][1] for m in DP_LOOP_RUNS}
    PLAIN_LAUNCHES.update({m: res["plain", m][1]
                           for m in A14_MODULES[5]})
    sheets = {m: len(os.listdir(os.path.join(
        dirs["nccl"], sub, "results", f"{sub}_images")))
        for m, sub in (("train_wggan", "wgan"), ("train_gan", "gan"))}
    want = {"train_wggan": 5 * ((WGAN_CRITIC + 1) * 2 + sheets["train_wggan"]),
            "train_gan": 5 * (2 * 2 * 2 + sheets["train_gan"]),
            "train_cgan": 0, "train_classifier": 0,
            "generate_synthetic": 5 * 2}
    for m, n in want.items():
        check(launches[m].get("convt4x4s2_fused", 0) == n, (m, launches[m]))
    check(launches["train_classifier"].get("mixed_gather", 0) == 2,
          launches["train_classifier"])
    c0, c1 = (load(n, "clf", "metrics", "augmented_training_history.json")
              for n in ("plain", "nccl"))
    worst["train_classifier"] = max(f32_close(c1[k], c0[k]) for k in c0)
    check(worst["train_classifier"] <= 1e-4, worst["train_classifier"])
    syn = [os.path.join(dirs[n], "synthetic") for n in ("plain", "nccl")]
    names = sorted(os.listdir(syn[0]))
    check(len(names) == 100 and names == sorted(os.listdir(syn[1]))
          and all(open(os.path.join(syn[0], f), "rb").read()
                  == open(os.path.join(syn[1], f), "rb").read()
                  for f in names), "the launched sampler's PNGs differ")
    print("dp CLIs (A14 part 2), world-1 NCCL with --shard-store against no "
          "group (f32, TF32 off, deterministic cuDNN), worst |a-b|/(1+|b|) "
          "per step: " + "; ".join(
              f"{m} {[float(f'{v:.3g}') for v in w]}"
              if isinstance(w, list) else f"{m} {w:.3g}"
              for m, w in worst.items())
          + f" (limits: step 1 1e-4, all 5e-2; "
          f"classifier 1e-4); the "
          f"sampler's 100 PNGs byte-equal; launches "
          + "; ".join(f"{m} {launches[m]}" for m in DP_LOOP_RUNS)
          + f" [{smi}]")
    return (sum(v.get("convt4x4s2_fused", 0) for v in launches.values()),
            launches["train_classifier"]["mixed_gather"])


def in_fresh_ranks(phase: str, world: int, tmp: str, smi: str) -> list:
    """``world`` new processes of this script, ``--phase phase/RANK``,
    each under a ``torchrun`` environment of its rank with LOCAL_RANK 0
    (every rank on the one card); prints their output and returns each
    rank's result."""
    return finish_fresh_ranks(start_fresh_ranks(phase, world, tmp, smi))


def start_fresh_ranks(phase: str, world: int, tmp: str, smi: str):
    """Starts :func:`in_fresh_ranks`' processes without waiting for them;
    :func:`finish_fresh_ranks` does."""
    port = free_port()
    logs = [os.path.join(tmp, f"{phase}_rank{r}.log") for r in range(world)]
    procs = [interpreter(["--phase", f"{phase}/{r}", tmp, smi],
                         {k: v for k, v in launch_env(r, world, 0,
                                                      port).items()
                          if k in LAUNCH_KEYS}, logs[r])
             for r in range(world)]
    return phase, procs, logs


def finish_fresh_ranks(started) -> list:
    """Waits for the ranks :func:`start_fresh_ranks` started, prints their
    output and returns each rank's result."""
    phase, procs, logs = started
    try:
        rcs = [p.wait(timeout=300) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    outs = []
    for r, path in enumerate(logs):  # every rank's output, then the checks
        with open(path) as f:
            lines = f.read().splitlines()
        res = [ln for ln in lines if ln.startswith('{"result": ')]
        print("\n".join(f"[rank {r}] {ln}" for ln in lines if ln not in res))
        outs.append((lines, res))
    for r, (lines, res) in enumerate(outs):
        check(rcs[r] == 0 and len(res) == 1,
              f"phase {phase} rank {r}: exit {rcs[r]}; the end of its "
              f"output:\n" + "\n".join(lines[-40:]))
    return [json.loads(res[0])["result"] for _, res in outs]


def timed_steps(step, n: int, mesh=None, warm: int = 3) -> float:
    """ms per call of ``step`` over ``n`` calls after ``warm`` warm ones,
    by the host clock around work that ends in a synchronise (and, with
    ``mesh``, starts and ends at a barrier of its ranks)."""
    for _ in range(warm):
        step()
    torch.cuda.synchronize()
    if mesh is not None:
        mesh.barrier()
    t0 = time.perf_counter()
    for _ in range(n):
        step()
    torch.cuda.synchronize()
    if mesh is not None:
        mesh.barrier()
    return (time.perf_counter() - t0) / n * 1e3


def dist_classifier(dev, mesh, dtype, seed: int):
    """A seeded ResNet-50 (frozen base, as the CLI's default) tied to
    ``mesh``, its optimizer, and a seeded 256-image synthetic store."""
    from xgan_torch.data.pipeline import DeviceStore
    from xgan_torch.data.store import ImageStore
    from xgan_torch.models.layers import sync_batch_norm
    from xgan_torch.models.resnet import ResNet50
    from xgan_torch.train.classifier import classifier_optimizer
    g = torch.Generator(device=dev).manual_seed(seed)
    model = ResNet50(2, dtype=dtype, device=dev, generator=g)
    sync_batch_norm(model, mesh)
    rng = np.random.default_rng(seed)
    synth = DeviceStore(ImageStore(
        rng.integers(0, 256, (256, SIZE, SIZE, 3), np.uint8),
        np.ones(256, np.int32), SIZE), dev)
    return model, classifier_optimizer(model, 1e-3, True), synth


def dist_draws(dev, b: int, seed: int):
    """A seeded (B,) batch of the train store with the mixer's and the
    flip's draws."""
    g = torch.Generator(device=dev).manual_seed(seed)
    return (torch.randint(0, N_TRAIN, (b,), generator=g, device=dev),
            torch.rand(b, generator=g, device=dev) < 0.5,
            torch.randint(0, 256, (b,), generator=g, device=dev),
            torch.rand(b, generator=g, device=dev) < 0.5)


def params_close(a: dict, b: dict, steps: int, lr: float) -> tuple:
    """(max |a - b|, elements outside rtol 2e-3 / atol 2e-5, elements)
    over two state dicts' float tensors after ``steps`` Adam steps from
    fresh moments. Adam's first steps move a coordinate by up to lr
    whatever its gradient, so one whose gradient is rounding noise may
    move lr either way: only 2 * lr a step (and f32 rounding) is held;
    the gradients are held by :func:`grad_norms_close`."""
    worst, outside, total = 0.0, 0, 0
    for k, v in b.items():
        if not v.is_floating_point():
            continue
        d = (a[k].double() - v.double()).abs()
        worst = max(worst, d.max().item())
        outside += int((d > 2e-5 + 2e-3 * v.double().abs()).sum())
        total += v.numel()
    check(worst <= 2 * lr * steps + 1e-6, (worst, outside, total))
    return worst, outside, total


def grad_norms(*nets) -> dict:
    """Each parameter's gradient norm, by name, over ``nets``."""
    return {f"{i}.{n}": p.grad.norm().item() for i, net in enumerate(nets)
            for n, p in net.named_parameters() if p.grad is not None}


def grad_norms_ratio(a: dict, b: dict, floor: dict | None = None,
                     skip=()) -> float:
    """Worst ratio of two runs' per-tensor relative gradient-norm
    difference to its limit: 1e-3 (the f32 step limit of
    ``phase_gan_step_check``) plus twice ``floor``'s relative difference
    from ``b`` where given (a run whose difference from ``b`` is rounding
    alone, as ``hold_f32_kernel_step`` measures one). ``skip``: tensors
    not held (a gradient that is 0 in exact arithmetic)."""
    check(a.keys() == b.keys() and a, (sorted(a), sorted(b)))

    def rel(x, k):
        return abs(x[k] - b[k]) / max(b[k], 1e-30)

    return max(rel(a, k) / (1e-3 + (2 * rel(floor, k) if floor else 0.0))
               for k in b if k not in skip)


def grad_norms_close(a: dict, b: dict, floor: dict | None = None,
                     skip=()) -> float:
    """:func:`grad_norms_ratio`, held at 1 or under."""
    worst = grad_norms_ratio(a, b, floor, skip)
    check(worst <= 1.0, worst)
    return worst


@contextlib.contextmanager
def counted_all_reduce():
    """Counts the calls of ``torch.distributed.all_reduce`` made inside
    and the bytes they reduce (``calls``, ``bytes``)."""
    import torch.distributed as dist
    seen = collections.Counter()
    orig = dist.all_reduce

    def counted(t, *args, **kwargs):
        seen["calls"] += 1
        seen["bytes"] += t.numel() * t.element_size()
        return orig(t, *args, **kwargs)

    dist.all_reduce = counted
    try:
        yield seen
    finally:
        dist.all_reduce = orig


def dp_step_checks(mesh, store, sharded=None) -> dict:
    """f32 steps through ``mesh`` against one rank's step on the same
    inputs and state (TF32 off, deterministic cuDNN): a DCGAN-224 step at
    B = 128 after 3 shared warm-up steps from the seeded reference init
    (from fresh weights rounding alone moves gradient norms past 1e-3, as
    ``hold_f32_kernel_step`` found), and a classifier step (ResNet-50,
    mix, frozen base, B = 32). The one-rank reference passes an all-ones
    mask, BN's one-pass masked statistics (the DP path combines centred
    moments since C10's fix; at these inits both hold): metrics within
    1e-4 * (1 + |ref|), per-tensor gradient norms within 1e-3 (plus twice
    the floor of the same DCGAN reference step over its rows in another
    order), parameters by :func:`params_close`. The same against the plain one-rank step
    (``F.batch_norm``'s two-pass variance) is printed, not held. With
    ``sharded`` (the train store split over the ranks) also the
    classifier step over it, bitwise the replicated one. Returns the
    deviations, the all-reduces a step, the DP steps' launches and their
    parameters."""
    import copy
    from xgan_torch import kernels
    from xgan_torch.models.layers import sync_batch_norm
    from xgan_torch.train.classifier import train_step
    from xgan_torch.train.gan import dcgan_step
    dev = mesh.device
    g = torch.Generator(device=dev).manual_seed(61)
    draws = [(torch.randint(0, N_TRAIN, (GAN_B,), generator=g, device=dev),
              torch.rand(GAN_B, generator=g, device=dev) < 0.5,
              torch.randn(GAN_B, LATENT, generator=g, device=dev))
             for _ in range(4)]
    out = {"launches": [0, 0], "all_reduce": {}}
    gn, dn, og, od = gan_models(torch.float32, seed=60)
    for idx, flip, noise in draws[:3]:
        dcgan_step(gn, dn, og, od, store.images, idx, latent_dim=LATENT,
                   flip=flip, noise=noise)
    warm = copy.deepcopy([x.state_dict() for x in (gn, dn, og, od)])
    idx, flip, noise = draws[3]
    ones = torch.ones(GAN_B, device=dev)
    # the floor: the reference on the same rows in another order (the
    # second half first, as the ranks split them), rounding alone
    swap = torch.arange(GAN_B, device=dev).roll(GAN_B // 2)
    nets = {}
    for name, m, mask in (("dp", mesh, None), ("ref", None, ones),
                          ("floor", None, ones), ("plain", None, None)):
        rows = swap if name == "floor" else slice(None)
        for x, sd in zip((gn, dn, og, od), copy.deepcopy(warm)):
            x.load_state_dict(sd)
        sync_batch_norm(gn, m)
        sync_batch_norm(dn, m)
        kernels.reset_launch_counts()
        with counted_all_reduce() as seen:
            metrics = dcgan_step(gn, dn, og, od, store.images, idx[rows],
                                 latent_dim=LATENT, flip=flip[rows],
                                 noise=noise[rows], mask=mask,
                                 take=store.take, mesh=m)
            torch.cuda.synchronize()
        check(kernels.LAUNCHES["convt4x4s2_fused"] == 5,
              dict(kernels.LAUNCHES))
        if name == "dp":
            out["launches"][0] += 5
            out["all_reduce"]["DCGAN"] = dict(seen)
        nets[name] = (metrics.tolist(), {
            **{f"g.{k}": v.clone() for k, v in gn.state_dict().items()},
            **{f"d.{k}": v.clone() for k, v in dn.state_dict().items()}},
            grad_norms(gn, dn))
    out["gan"] = f32_close(nets["dp"][0], nets["ref"][0])
    check(out["gan"] <= 1e-4, out["gan"])
    out["gan_grads"] = grad_norms_close(nets["dp"][2], nets["ref"][2],
                                        nets["floor"][2])
    out["gan_floor"] = max(abs(nets["floor"][2][k] - v) / max(v, 1e-30)
                           for k, v in nets["ref"][2].items())
    out["gan_params"] = params_close(nets["dp"][1], nets["ref"][1], 1, 2e-4)
    plain = nets["plain"]
    out["gan_plain"] = (f32_close(nets["dp"][0], plain[0]), max(
        abs(nets["dp"][2][k] - v) / max(v, 1e-30)
        for k, v in plain[2].items()))

    idx, use, pick, cflip = dist_draws(dev, CLS_B, 62)
    kw = dict(mode="mix", ratio=0.5, flip=cflip, use_synth=use,
              synth_pick=pick)
    runs = [("dp", store, mesh, None),
            ("ref", store, None, torch.ones(CLS_B, device=dev))]
    if sharded is not None:
        runs.append(("sharded", sharded, mesh, None))
    steps = {}
    for name, real, m, mask in runs:
        model, opt, synth = dist_classifier(dev, m, torch.float32, 63)
        kernels.reset_launch_counts()
        with counted_all_reduce() as seen:
            got = train_step(model, opt, real, synth, idx, mesh=m,
                             mask=mask, **kw)
            torch.cuda.synchronize()
        n = kernels.LAUNCHES["mixed_gather"]
        check(n == (0 if name == "sharded" else 1), (name, n))
        if m is not None:
            out["all_reduce"][f"classifier {name}"] = dict(seen)
        if name == "dp":
            out["launches"][1] += n
            out["unfrozen_grad_bytes"] = 4 * sum(
                p.numel() for p in model.parameters())
        steps[name] = ([t.float() for t in got], model.state_dict(),
                       grad_norms(model))
    out["clf"] = f32_close(steps["dp"][0][0].tolist(),
                           steps["ref"][0][0].tolist())
    check(out["clf"] <= 1e-4, out["clf"])
    out["clf_grads"] = grad_norms_close(steps["dp"][2], steps["ref"][2])
    out["clf_params"] = params_close(steps["dp"][1], steps["ref"][1], 1,
                                     1e-3)
    if sharded is not None:
        check(all(torch.equal(a, b) for a, b in zip(steps["dp"][0],
                                                    steps["sharded"][0]))
              and all(torch.equal(v, steps["sharded"][1][k])
                      for k, v in steps["dp"][1].items()),
              "the sharded store's step differs from the replicated one")
    out["states"] = {"gan": nets["dp"][1], "clf": steps["dp"][1],
                     "metrics": nets["dp"][0]}
    out["synth"], out["draws"] = synth, (idx, use, pick, cflip)
    return out


def dp_family_checks(mesh, store) -> dict:
    """f32 WGAN-GP (B = 16, 2 critic updates, fg = fd = 64) and CGAN
    (B = 16, fg = fd = 32, random VGG16; at epoch 0, the gate open, and at
    epoch 5 with the gate held closed as in ``phase_cgan_profile``) steps
    through ``mesh`` against one rank's step on the same inputs and state,
    after 3 warm-up steps of one rank (TF32 off, deterministic cuDNN; the
    one-rank steps normalize with ``F.batch_norm``'s two-pass statistics,
    which the ranks' Chan combine matches: against the one-pass sums path
    that the ranks took before C10's fix, the CGAN's gradient norms parted
    by 1.66 of their limit at its reference init):
    the losses or metrics within 1e-4 * (1 + |ref|); each tensor's
    gradient norm within 1e-3 plus twice its floor, the larger move of
    the reference over its rows in two other orders (the second half
    first, as the ranks split them, and reversed); the CGAN's biases
    right before a BN not held (their
    gradient is 0 in exact arithmetic). The control: the same DP step
    with TF32 on must fall outside these limits. Returns the deviations,
    the DP steps' ConvT launches and their parameters."""
    import copy
    from xgan_torch import kernels
    from xgan_torch.models.cgan import SEQ_D_BN
    from xgan_torch.models.layers import sync_batch_norm
    from xgan_torch.train.cgan import GATE_EPOCHS, cgan_step
    from xgan_torch.train.wgan import wgan_step
    dev = mesh.device
    b, n = 16, 2
    orders = {"floor": torch.arange(b, device=dev).roll(b // 2),
              "floor2": torch.arange(b - 1, -1, -1, device=dev)}
    gen = torch.Generator(device=dev).manual_seed(81)
    out = {"launches": 0, "states": {}}

    def draw(*shape, normal=True):
        return (torch.randn if normal else torch.rand)(
            shape, generator=gen, device=dev)

    def hold(label, runs, skip=()):
        """runs: name -> (metrics list, grad norms); returns the record."""
        dp, ref, tf = (runs[k] for k in ("dp", "ref", "tf32"))
        # per tensor, the run of the two reorderings further from ref
        floor = {k: max((runs[f][1][k] for f in orders),
                        key=lambda x: abs(x - v))
                 for k, v in ref[1].items()}
        rec = {"metrics": f32_close(dp[0], ref[0]),
               "norms": grad_norms_ratio(dp[1], ref[1], floor, skip),
               "floor": max(abs(floor[k] - v) / max(v, 1e-30)
                            for k, v in ref[1].items() if k not in skip),
               "tf32": (f32_close(tf[0], ref[0]),
                        grad_norms_ratio(tf[1], ref[1], floor, skip))}
        check(rec["metrics"] <= 1e-4 and rec["norms"] <= 1.0, (label, rec))
        check(rec["tf32"][0] > 1e-4 or rec["tf32"][1] > 1.0,
              f"{label}: a TF32 step passes the f32 limits too ({rec})")
        return rec

    def with_tf32(on: bool):
        torch.backends.cuda.matmul.allow_tf32 = on
        torch.backends.cudnn.allow_tf32 = on

    # -- WGAN-GP
    nets = wgan_models(torch.float32, seed=80)
    for _ in range(3):
        wgan_step(*nets, store.images,
                  torch.randint(0, N_TRAIN, (b,), generator=gen, device=dev),
                  latent_dim=LATENT, critic_iters=n, lambda_gp=10.0,
                  generator=gen)
    warm = copy.deepcopy([x.state_dict() for x in nets])
    idx = torch.randint(0, N_TRAIN, (b,), generator=gen, device=dev)
    draws = {"flip": draw(b, normal=False) < 0.5,
             "noises": [draw(b, LATENT) for _ in range(n)],
             "alphas": [draw(b, 1, 1, 1, normal=False) for _ in range(n)],
             "g_noise": draw(b, LATENT)}
    runs = {}
    for name, m, rows in (("dp", mesh, slice(None)),
                          ("ref", None, slice(None)),
                          *((f, None, o) for f, o in orders.items()),
                          ("tf32", mesh, slice(None))):
        for x, sd in zip(nets, copy.deepcopy(warm)):
            x.load_state_dict(sd)
        sync_batch_norm(nets[0], m)
        sync_batch_norm(nets[1], m)
        with_tf32(name == "tf32")
        kernels.reset_launch_counts()
        try:
            losses = wgan_step(
                *nets, store.images, idx[rows], latent_dim=LATENT,
                critic_iters=n, lambda_gp=10.0, flip=draws["flip"][rows],
                noises=[t[rows] for t in draws["noises"]],
                alphas=[t[rows] for t in draws["alphas"]],
                g_noise=draws["g_noise"][rows], take=store.take, mesh=m)
            torch.cuda.synchronize()
        finally:
            with_tf32(False)
        check(kernels.LAUNCHES["convt4x4s2_fused"] == 5 * (n + 1),
              dict(kernels.LAUNCHES))
        if name == "dp":
            out["launches"] += 5 * (n + 1)
            out["states"]["wgan"] = {
                **{f"g.{k}": v.clone() for k, v in nets[0].state_dict().items()},
                **{f"c.{k}": v.clone() for k, v in nets[1].state_dict().items()}}
        runs[name] = (losses.tolist(), {
            f"{net}.{k}": p.grad.norm().item()
            for net, x in (("G", nets[0]), ("C", nets[1]))
            for k, p in x.named_parameters()})
    out["wgan"] = hold("f32 WGAN-GP DP step", runs)

    # -- CGAN, the gate open (epoch 0) and held closed (epoch 5)
    nets = cgan_models(dev, torch.float32, seed=82)
    for _ in range(3):
        cgan_step(*nets, store.images, store.labels,
                  torch.randint(0, N_TRAIN, (b,), generator=gen, device=dev),
                  0, latent_dim=LATENT, generator=gen)
    warm = copy.deepcopy([x.state_dict() for x in nets[:2] + nets[3:]])
    idx = torch.randint(0, N_TRAIN, (b,), generator=gen, device=dev)
    base = {"flip": draw(b, normal=False) < 0.5, "noise": draw(b, LATENT),
            "fake_labels": torch.randint(0, 2, (b,), generator=gen,
                                         device=dev),
            "real_targets": 0.9 - 0.1 * draw(b, normal=False),
            "fake_targets": 0.1 + 0.1 * draw(b, normal=False)}
    g, d, vgg, opt_g, opt_d = nets
    for gate in ("open", "closed"):
        closed = gate == "closed"
        draws = dict(base)
        labels = store.labels
        if closed:
            labels = torch.zeros_like(store.labels)
            draws["fake_labels"] = torch.ones(b, dtype=torch.int64,
                                              device=dev)
        runs = {}
        for name, m, rows in (("dp", mesh, slice(None)),
                              ("ref", None, slice(None)),
                              *((f, None, o) for f, o in orders.items()),
                              ("tf32", mesh, slice(None))):
            for x, sd in zip((g, d, opt_g, opt_d), copy.deepcopy(warm)):
                x.load_state_dict(sd)
            if closed:  # D's projection pins the gate shut
                emb, bn = d.label_emb.weight, d.main[SEQ_D_BN[-1]]
                c = 500.0 / emb.shape[1]
                with torch.no_grad():
                    emb[0], emb[1] = c, -c
                    bn.weight.zero_()
                    bn.bias.fill_(1.0)
            before = [p.detach().clone() for p in d.parameters()]
            sync_batch_norm(g, m)
            sync_batch_norm(d, m)
            with_tf32(name == "tf32")
            try:
                metrics = cgan_step(
                    g, d, vgg, opt_g, opt_d, store.images, labels, idx[rows],
                    GATE_EPOCHS if closed else 0, latent_dim=LATENT,
                    take=store.take, mesh=m,
                    **{k: v[rows] for k, v in draws.items()})
                torch.cuda.synchronize()
            finally:
                with_tf32(False)
            mt = metrics.tolist()
            stood = all(torch.equal(p, q) for p, q in zip(d.parameters(),
                                                          before))
            check(stood == closed
                  and ((mt[2] >= 0.8 and mt[3] <= 0.2) == closed),
                  (gate, name, mt[2:4], stood))
            if name == "dp":
                out["states"][f"cgan_{gate}"] = {
                    **{f"g.{k}": v.clone() for k, v in g.state_dict().items()},
                    **{f"d.{k}": v.clone() for k, v in d.state_dict().items()}}
            runs[name] = (mt, {f"{net}.{k}": p.grad.norm().item()
                               for net, x in (("G", g), ("D", d))
                               for k, p in x.named_parameters()})
        out[f"cgan_{gate}"] = hold(f"f32 CGAN DP step, gate {gate}", runs,
                                   pre_bn_biases())
    return out


def dp_family_line(out: dict) -> str:
    return "; ".join(
        f"{k}: metrics {r['metrics']:.3g} (limit 1e-4), gradient norms at "
        f"{r['norms']:.3g} of their limit (1e-3 + 2 floor; floor up to "
        f"{r['floor']:.3g}); TF32 control {r['tf32'][0]:.3g} and "
        f"{r['tf32'][1]:.3g}"
        for k, r in out.items() if k in ("wgan", "cgan_open", "cgan_closed"))


def dp_sampler_rows(mesh, smi: str) -> int:
    """The three samplers at full width (DCGAN and WGAN-GP G-224 with
    fg = 64, CGAN with fg = 32, seeded weights) on the ranks' rows: 50
    images in global batches of 32, each rank rendering and writing its
    16 rows of a batch; then rank 0 renders them as one rank. f32: the
    files byte-equal; bf16 (the DCGAN G): every pixel within 3 u8 levels
    (a smaller batch may take another ConvT tile). Returns this rank's
    ConvT launches."""
    from xgan_torch import kernels
    from xgan_torch.models import cgan, dcgan, wgan
    from xgan_torch.native.png import decode_png
    from xgan_torch.train.sample import generate_images
    runs = {"dcgan": (dcgan.Generator, FG, torch.float32),
            "wgan": (wgan.Generator, FG, torch.float32),
            "cgan": (cgan.Generator, CGAN_FM, torch.float32),
            "dcgan_bf16": (dcgan.Generator, FG, torch.bfloat16)}
    root = os.path.join(CHILD_TMP, "dist_sampler")
    launched, worst = 0, {}
    for i, (name, (cls, fm, dtype)) in enumerate(runs.items()):
        g = cls(latent_dim=LATENT, feature_maps=fm, image_size=SIZE,
                device=mesh.device,
                generator=torch.Generator(mesh.device).manual_seed(90 + i))
        kw = dict(num_images=50, latent_dim=LATENT, batch_size=32, seed=7,
                  device=mesh.device, dtype=dtype,
                  conditional=name == "cgan")
        kernels.reset_launch_counts()
        generate_images(g, output_dir=os.path.join(root, name, "two"),
                        mesh=mesh, **kw)
        check(kernels.LAUNCHES["convt4x4s2_fused"]
              == (0 if name == "cgan" else 2 * 5), dict(kernels.LAUNCHES))
        launched += kernels.LAUNCHES["convt4x4s2_fused"]
        mesh.barrier()
        if not mesh.is_main:
            continue
        generate_images(g, output_dir=os.path.join(root, name, "one"), **kw)
        dirs = [os.path.join(root, name, s) for s in ("one", "two")]
        files = [sorted(os.listdir(x)) for x in dirs]
        check(files[0] == files[1] and len(files[0]) == 50,
              (name, len(files[0]), len(files[1])))
        if dtype == torch.float32:
            same = sum(open(os.path.join(dirs[0], f), "rb").read()
                       == open(os.path.join(dirs[1], f), "rb").read()
                       for f in files[0])
            worst[name] = f"{same} of 50 files byte-equal"
            check(same == 50, (name, worst[name]))
        else:
            lv = max(int(np.abs(decode_png(os.path.join(dirs[0], f))
                                .astype(np.int16)
                                - decode_png(os.path.join(dirs[1], f))
                                .astype(np.int16)).max())
                     for f in files[0])
            worst[name] = f"max {lv} u8 levels"
            check(lv <= 3, (name, lv))
    if mesh.is_main:
        print("dist samplers, 2 ranks' rows against one rank (50 PNGs, "
              "batch 32, 224 px): " + "; ".join(
                  f"{k} {v}" for k, v in worst.items()) + f" [{smi}]")
    return launched


def dp_summary(label: str, c: dict, smi: str) -> None:
    print(f"{label}: f32 DCGAN-224 B={GAN_B} step against no group: metrics "
          f"{c['gan']:.3g} (limit 1e-4), gradient norms at "
          f"{c['gan_grads']:.3g} of their limit (1e-3 + 2 floor; the floor, "
          f"the reference over its rows in another order, up to "
          f"{c['gan_floor']:.3g}), parameters max |diff| "
          f"{c['gan_params'][0]:.3g} "
          f"(limit 2 lr), {c['gan_params'][1]} of {c['gan_params'][2]} "
          f"outside rtol 2e-3/atol 2e-5; f32 classifier B={CLS_B} mix "
          f"step: losses {c['clf']:.3g}, gradient norms at "
          f"{c['clf_grads']:.3g} of 1e-3, parameters max |diff| "
          f"{c['clf_params'][0]:.3g}, {c['clf_params'][1]} of "
          f"{c['clf_params'][2]} outside (against one rank's sums-path "
          f"BN); against the plain one-rank DCGAN step (not held): metrics "
          f"{c['gan_plain'][0]:.3g}, gradient norms {c['gan_plain'][1]:.3g}; "
          "all-reduces a step (calls, bytes): "
          + "; ".join(f"{k} {v['calls']}, {v['bytes']}"
                      for k, v in c["all_reduce"].items())
          + f"; ResNet-50's gradients under --unfreeze would add "
          f"{c['unfrozen_grad_bytes']} bytes [{smi}]")


def phase_dist(train, smi: str, rank: int) -> list:
    """(b) One rank of two sharing the card over gloo's CUDA all-reduce
    (``--phase dist/RANK``): :func:`dp_step_checks` with ``--shard-store``'s
    store; this rank's gathered rows bitwise against the plain version and
    against its rows of the 1-rank gather, and the sharded take bitwise
    against the replicated rows; bf16 steps timed. Saves its parameters
    for the parent's bitwise check of the ranks; returns its (ConvT,
    mixed_gather) launches."""
    from xgan_torch import kernels
    from xgan_torch.data.pipeline import DeviceStore
    from xgan_torch.kernels.gather import (mixed_gather, mixed_gather_ranks,
                                           mixed_gather_ref, new_error_flag,
                                           raise_if_flagged)
    from xgan_torch.models.layers import sync_batch_norm
    from xgan_torch.parallel.mesh import init_from_env, shutdown
    from xgan_torch.train.classifier import assemble, train_step
    from xgan_torch.train.gan import dcgan_step
    mesh = init_from_env(cpu=False, backend="gloo")
    dev = mesh.device
    check(mesh.world == 2 and mesh.rank == rank and dev.index == 0,
          (mesh, dev))
    torch.backends.cudnn.deterministic = True
    rows = mesh.local_rows(CLS_B)
    try:
        store = DeviceStore(train, dev)
        sharded = DeviceStore(train, dev, mesh, shard=True)
        nbytes = [s.images.numel() for s in (store, sharded)]
        check(nbytes[1] * 2 == nbytes[0], nbytes)
        c = dp_step_checks(mesh, store, sharded)
        launched = c["launches"]
        fam = dp_family_checks(mesh, store)
        launched[0] += fam["launches"] + dp_sampler_rows(mesh, smi)

        # this rank's rows of the gather, and the sharded take
        synth, (idx, use, pick, flip) = c["synth"], c["draws"]
        mine, _ = assemble("mix", store, synth, idx, use_synth=use,
                           synth_pick=pick, rows=rows)
        full = mixed_gather(store.images, synth.images, idx, pick, use)
        plain = mixed_gather_ref(store.images, synth.images, idx[rows],
                                 pick[rows], use[rows])
        taken = sharded.take(sharded.images, idx, rows)
        check(torch.equal(mine, plain) and torch.equal(mine, full[rows])
              and torch.equal(taken, store.images[idx[rows]]),
              "rank rows differ")
        b = rows.stop - rows.start
        nbytes_g = 2 * b * SIZE * SIZE * 3 + 2 * b * 8 + b  # as phase_gather
        err = new_error_flag(dev)  # read once, after the timed calls
        gather_ms = [time_ms(lambda: mixed_gather_ranks(
            store.images, synth.images, idx, pick, use, rows, err),
            reps=64),
            time_ms(lambda: mixed_gather_ref(
                store.images, synth.images, idx[rows], pick[rows],
                use[rows]), reps=64),
            time_ms(lambda: torch.where(
                use[rows][:, None, None, None], synth.images[pick[rows]],
                store.images[idx[rows]]), reps=64)]
        raise_if_flagged(err)

        # bf16 timings of two ranks sharing the card
        gn, dn, og, od = gan_models(torch.bfloat16, seed=64)
        sync_batch_norm(gn, mesh)
        sync_batch_norm(dn, mesh)
        gen = torch.Generator(device=dev).manual_seed(65)
        gidx = torch.randint(0, N_TRAIN, (GAN_B,), generator=gen, device=dev)
        kernels.reset_launch_counts()
        gan_ms = timed_steps(lambda: dcgan_step(
            gn, dn, og, od, store.images, gidx, latent_dim=LATENT,
            generator=gen, mesh=mesh), 5, mesh)
        check(on_new_designs(kernels.LAUNCHES,
                             kernels.LAUNCHES["convt4x4s2_fused"]),
              dict(kernels.LAUNCHES))
        launched[0] += kernels.LAUNCHES["convt4x4s2_fused"]
        model, opt, synth = dist_classifier(dev, mesh, torch.bfloat16, 66)
        kernels.reset_launch_counts()
        clf_ms = timed_steps(lambda: train_step(
            model, opt, store, synth, idx, mode="mix", ratio=0.5,
            flip=flip, use_synth=use, synth_pick=pick, mesh=mesh), 10, mesh)
        launched[1] += kernels.LAUNCHES["mixed_gather"]
        torch.save({**c["states"], **fam["states"]},
                   os.path.join(CHILD_TMP, f"dist_rank{rank}.pt"))
    finally:
        shutdown(mesh)
    dp_summary(f"rank {rank} of 2 (gloo, one card)", c, smi)
    print(f"rank {rank} of 2, f32 steps through the group against one "
          f"rank (B = 16, 224 px, after 3 warm-up steps): "
          f"{dp_family_line(fam)} [{smi}]")
    print(f"rank {rank}: the sharded store's step bitwise the replicated "
          f"one; its {CLS_B // 2} gathered rows bitwise the plain "
          f"version's and the 1-rank gather's; the per-rank gather "
          f"(mixed_gather_ranks, {b} rows) {gather_ms[0]:.4f} ms, plain "
          f"{gather_ms[1]:.4f} ms, torch.where {gather_ms[2]:.4f} ms, "
          f"bound {_bytes_ms(nbytes_g):.4f} ms ({nbytes_g} bytes; both "
          f"ranks time at once); store bytes per rank: "
          f"replicated {nbytes[0]}, sharded {nbytes[1]}; bf16 ms per step, "
          f"two ranks sharing one card over host-staged gloo (not a "
          f"scaling figure): DCGAN B={GAN_B} {gan_ms:.3f}, classifier "
          f"B={CLS_B} mix {clf_ms:.3f} [{smi}]")
    return launched


# the turns of phase_dist1's timings
DIST1_TURNS = ("none", "group")


def phase_dist1(train, smi: str, run: int) -> list:
    """The DP path on one card: one rank of a world-1 NCCL group
    (``--phase dist1``) holds :func:`dp_step_checks`, then times bf16
    DCGAN-224 steps (B = 128), classifier steps (ResNet-50, mix, B = 32)
    and accumulated DCGAN-224 steps (B = 128, A = 2) with the group (every
    all-reduce of the DP path) against the same steps with none, in turns
    ``DIST1_TURNS``. (The WGAN-GP and CGAN steps' are timed at
    K = 1 and K = 4 by :func:`phase_kstep_dp`.) Returns the group steps'
    (ConvT, mixed_gather) launches."""
    from xgan_torch import kernels
    from xgan_torch.data.pipeline import DeviceStore
    from xgan_torch.models.layers import sync_batch_norm
    from xgan_torch.parallel.mesh import init_from_env, shutdown
    from xgan_torch.train.classifier import train_step
    from xgan_torch.train.gan import dcgan_step
    mesh = init_from_env(cpu=False)
    dev = mesh.device
    check(mesh.distributed and mesh.world == 1, mesh)
    times = collections.defaultdict(list)
    torch.backends.cudnn.deterministic = True
    try:
        store = DeviceStore(train, dev)
        c = dp_step_checks(mesh, store)
        launched = c["launches"]
        torch.backends.cudnn.deterministic = False
        idx, use, pick, flip = dist_draws(dev, CLS_B, 70)
        gan, clf, fam = {}, {}, {}
        for name, m in (("none", None), ("group", mesh)):
            gn, dn, og, od = gan_models(torch.bfloat16, seed=71)
            sync_batch_norm(gn, m)
            sync_batch_norm(dn, m)
            gen = torch.Generator(device=dev).manual_seed(72)
            gidx = torch.randint(0, N_TRAIN, (GAN_B,), generator=gen,
                                 device=dev)
            gan[name] = (lambda gn=gn, dn=dn, og=og, od=od, gen=gen,
                         gidx=gidx, m=m: dcgan_step(
                             gn, dn, og, od, store.images, gidx,
                             latent_dim=LATENT, generator=gen, mesh=m))
            model, opt, synth = dist_classifier(dev, m, torch.bfloat16, 73)
            clf[name] = (lambda model=model, opt=opt, synth=synth, m=m:
                         train_step(model, opt, store, synth, idx,
                                    mode="mix", ratio=0.5, flip=flip,
                                    use_synth=use, synth_pick=pick, mesh=m))
            # A14 part 2: the accumulated DCGAN step (the WGAN-GP and
            # CGAN steps are timed at K = 1 and K = 4 by phase_kstep_dp)
            ga, da, oga, oda = gan_models(torch.bfloat16, seed=76)
            for net in (ga, da):
                sync_batch_norm(net, m)
            fam[name] = {
                "accum": lambda nets=(ga, da, oga, oda), m=m, gen=gen,
                gidx=gidx: dcgan_step(
                    *nets, store.images, gidx, latent_dim=LATENT,
                    generator=gen, grad_accum=2, mesh=m)}
        timed = [0, 0]
        # timed calls of each step a turn (3 warm ones first), its ConvT
        # launches a call
        calls = {"gan": (10, 5), "clf": (10, 0), "accum": (5, 2 * 2 * 5)}
        for name in DIST1_TURNS:
            kernels.reset_launch_counts()
            times[f"gan {name}"].append(timed_steps(gan[name], 10))
            times[f"clf {name}"].append(timed_steps(clf[name], 10))
            for k, fn in fam[name].items():
                times[f"{k} {name}"].append(timed_steps(fn, calls[k][0]))
            check(on_new_designs(kernels.LAUNCHES,
                                 kernels.LAUNCHES["convt4x4s2_fused"]),
                  dict(kernels.LAUNCHES))
            if name == "group":
                timed[0] += kernels.LAUNCHES["convt4x4s2_fused"]
                timed[1] += kernels.LAUNCHES["mixed_gather"]
    finally:
        shutdown(mesh)
    turns = DIST1_TURNS.count("group")
    check(timed == [turns * sum((n + 3) * k for n, k in calls.values()),
                    turns * 13], timed)
    dp_summary("world-1 NCCL group", c, smi)
    print(f"world-1 NCCL DP path against no group, bf16 ms per step (turns "
          f"{', '.join(DIST1_TURNS)}): DCGAN-224 B={GAN_B} none "
          f"{times['gan none']} group {times['gan group']}; classifier "
          f"B={CLS_B} mix none {times['clf none']} group "
          f"{times['clf group']}; DCGAN-224 B={GAN_B} --grad-accum 2 none "
          f"{times['accum none']} group {times['accum group']} [{smi}]")
    return [a + b for a, b in zip(launched, timed)]


def phase_dp(tmp: str, root: str, synth_dir: str, smi: str,
             others: dict | None = None) -> list:
    """(a) and (b), after every earlier phase: the CLIs on NCCL at world 1
    (A14 parts 1 and 2), the cost of the DP path on one card, then two
    ranks on the card over gloo, whose parameters must be bitwise equal
    (DCGAN, classifier, WGAN-GP, CGAN with the gate open and closed).
    ``others``: processes started beside its CLIs
    (:func:`a14_4_processes`), drained in place into their (exit code,
    output) before the timed phases. Returns the DP paths' (ConvT,
    mixed_gather) launches."""
    procs = dp_cli_processes(tmp, root, synth_dir)
    try:
        launched = list(phase_dp_cli(tmp, root, synth_dir, smi, procs))
        launched = [a + b for a, b in zip(
            launched, phase_dp_cli_loops(tmp, root, synth_dir, smi, procs))]
        if others is not None:
            others.update(drain_all(others))
    finally:
        # those a failed check left running
        for proc in [*procs.values(), *(others or {}).values()]:
            if isinstance(proc, subprocess.Popen) and proc.poll() is None:
                proc.kill()
    for phase, world in (("dist1", 1), ("dist", 2)):
        for got in in_fresh_ranks(phase, world, tmp, smi):
            launched = [a + b for a, b in zip(launched, got)]
    ranks = [torch.load(os.path.join(tmp, f"dist_rank{r}.pt"),
                        weights_only=True) for r in range(2)]
    nets = ("gan", "clf", "wgan", "cgan_open", "cgan_closed")
    check(ranks[0]["metrics"] == ranks[1]["metrics"]
          and all(torch.equal(v, ranks[1][net][k])
                  for net in nets for k, v in ranks[0][net].items()),
          "the two ranks' parameters differ")
    print(f"dp: both ranks' parameters bitwise equal after their steps "
          f"({', '.join(nets)}); "
          f"launches on the DP paths: ConvT {launched[0]}, mixed_gather "
          f"{launched[1]}")
    check(all(launched), launched)
    return launched


# A14 part 3: --steps-per-call under a launch, --parallel-folds on the fold
# mesh, ZeRO-1 --shard-opt-state

KSTEP_B = {"dcgan": GAN_B, "wgan": WGAN_B, "cgan": CGAN_B}
KSTEP_TURNS = ("group",)  # the timed turns of phase_kstep_dp
# ConvT launches of one step of each (the CGAN's G launches none)
KSTEP_CONVT = {"dcgan": 5, "wgan": 5 * (WGAN_CRITIC + 1), "cgan": 0}


def kstep_setup(kind: str, store, mesh, dtype, steps: int, seed: int,
                k: int, b: int | None = None, zero1: bool = False):
    """The ``kind`` step (``dcgan``, ``wgan``, ``cgan``) at its full width
    and batch (or ``b``), the trainer's capturable Adam, its BN tied to
    ``mesh`` (a world-1 NCCL group, or None), over ``steps`` seeded
    batches as :func:`k_calls` of ``k`` steps a call (the CGAN's epoch a
    device input, 0). ``zero1``: each Adam a ``ShardedAdam`` built
    directly on ``mesh`` at the CLI's rule (``shard_opt_state`` returns
    the plain Adam at world 1), so that its NCCL all-gather runs. Returns
    (the calls, the dispatcher or None, the state by name)."""
    from xgan_torch.models.layers import sync_batch_norm
    from xgan_torch.train.cgan import cgan_step
    from xgan_torch.train.gan import dcgan_step
    from xgan_torch.train.wgan import wgan_step
    dev = store.images.device
    if kind == "dcgan":
        g, d, og, od = gan_models(dtype, seed=seed, capturable=True)
    elif kind == "wgan":
        g, d, og, od = wgan_models(dtype, seed=seed, capturable=True)
    else:
        g, d, vgg, og, od = cgan_models(dev, dtype, seed=seed,
                                        capturable=True)
    sync_batch_norm(g, mesh)
    sync_batch_norm(d, mesh)
    if zero1:
        from xgan_torch.parallel.tp import ShardedAdam, shard_dims
        og, od = (ShardedAdam(o, shard_dims([m], mesh.world), mesh)
                  for o, m in ((og, g), (od, d)))
    gen = torch.Generator(dev).manual_seed(seed + 2)
    idx = torch.randint(0, len(store), (steps, b or KSTEP_B[kind]),
                        device=dev,
                        generator=torch.Generator(dev).manual_seed(seed + 3))
    common = dict(latent_dim=LATENT, dtype=dtype, generator=gen, mesh=mesh)
    inputs = ()
    if kind == "dcgan":
        def step(i):
            return dcgan_step(g, d, og, od, store.images, i, **common)
    elif kind == "wgan":
        def step(i):
            return wgan_step(g, d, og, od, store.images, i,
                             critic_iters=WGAN_CRITIC, lambda_gp=10.0,
                             **common)
    else:
        inputs = (torch.zeros((), dtype=torch.int64, device=dev),)

        def step(i, epoch):
            return cgan_step(g, d, vgg, og, od, store.images, store.labels,
                             i, epoch, **common)
    calls, multi = k_calls(step, k, gen, idx, *inputs)
    return calls, multi, dict(G=g, D=d, opt_G=og, opt_D=od)


def kstep_holds(kd: str, store, mesh, lines: list) -> None:
    """The f32 holds of :func:`phase_kstep_dp` for the ``kd`` step
    (appends what it prints to ``lines``)."""
    torch.backends.cudnn.deterministic = True
    kstep_setup(kd, store, mesh, torch.float32, 1, 89, 1,
                KSTEP_B[kd])[0][0]()

    def f32_run(k, kd=kd, zero1=False):
        calls, multi, named = kstep_setup(
            kd, store, mesh, torch.float32, 8, seed=90, k=k,
            b=KSTEP_B[kd], zero1=zero1)
        metrics = torch.cat([c() for c in calls])
        torch.cuda.synchronize()
        return metrics, state_of(**named), multi

    try:
        hold_k_replay(f"{kd}-224 on the world-1 NCCL group",
                      f32_run, KSTEP_B[kd])
    except AssertionError:
        # which steps part, and whether no group parts too
        torch.backends.cudnn.deterministic = True
        for m in (mesh, None):
            runs = {}
            for k in (1, LOOP_K):
                calls, _, _ = kstep_setup(kd, store, m,
                                          torch.float32, 8, 90, k,
                                          KSTEP_B[kd])
                runs[k] = torch.cat([c() for c in calls])
            rel = ((runs[LOOP_K] - runs[1]).abs()
                   / (1 + runs[1].abs())).amax(1)
            print(f"{kd} f32 K={LOOP_K} vs K=1, "
                  f"{'group' if m else 'no group'}, worst "
                  f"|a-b|/(1+|b|) per step: {rel.tolist()}")
        raise
    if kd == "dcgan":
        # ZeRO-1's NCCL all-gather captured in the K-step graph
        torch.backends.cudnn.deterministic = True
        try:
            plain, zero = f32_run(LOOP_K), f32_run(LOOP_K, zero1=True)
        finally:
            torch.backends.cudnn.deterministic = False
        check(zero[2].replays >= 1 and torch.equal(zero[0], plain[0])
              and all(torch.equal(zero[1][n], v)
                      for n, v in plain[1].items()),
              "ZeRO-1 in the K-step graph differs from plain Adam")
        lines.append(
            f"dcgan-224 f32 K={LOOP_K}, 8 steps on the world-1 NCCL "
            f"group: with ShardedAdam (its all_gather_into_tensor "
            f"captured, {zero[2].replays} replays) the metrics, "
            f"parameters and whole Adam state bitwise plain Adam's")


def phase_kstep_dp(train_store, smi: str, kind: str) -> list:
    """``--steps-per-call`` on the DP path: one rank of a world-1 NCCL
    group (``--phase kstep_dcgan``: the DCGAN-224 step, B = 128, then the
    CGAN-224 step, B = 32; ``--phase kstep_wgan``: the WGAN-GP-224 step,
    B = 64, 5 critic updates), K = LOOP_K steps with their all-reduces
    captured in one CUDA graph:

    - first, once the card has ``KSTEP_FREE`` free and the other K-step
      phase's holds are done (:func:`card_turn`; other phases' processes
      may still run beside it), f32 (TF32 off, deterministic cuDNN), 8
      steps at the full batch after one warm-up step (the process's first
      f32 step picks other cuDNN algorithms: the WGAN-GP's first K = 1
      run parted from every later one by 1.5e-3): K = LOOP_K (an eager call, then a replay)
      against K = 1 eager steps through the group, the metrics and every
      state tensor within LOOP_TOL; then the DCGAN's K = LOOP_K run with
      a ``ShardedAdam`` built on the group (ZeRO-1 at world 1, its NCCL
      all-gather captured) bitwise the plain Adam's;
    - then, on the parent's go (:func:`ready_then_go`; nothing else runs
      on the card), a profiler window of one replay (the first of its
      process, C6): its ConvT kernels against the dispatcher's launches
      per replay;
    - bf16 ms per step of the group at K = 1 and K = LOOP_K
      (``KSTEP_TURNS``; no group's are phases 17, 19 and 20's; the
      WGAN-GP's 4 steps each).

    Returns [the timed and profiled steps' ConvT launches]."""
    from torch.autograd import DeviceType
    from xgan_torch import kernels
    from xgan_torch.data.pipeline import DeviceStore
    from xgan_torch.parallel.mesh import init_from_env, shutdown
    mesh = init_from_env(cpu=False)
    check(mesh.distributed and mesh.world == 1 and mesh.backend == "nccl",
          mesh)
    store = DeviceStore(train_store, mesh.device)
    launched = 0
    lines = []
    kinds = ("dcgan", "cgan") if kind == "dcgan" else (kind,)
    try:
        with card_turn(KSTEP_FREE):  # one K-step phase's holds at a time
            for kd in kinds:
                kstep_holds(kd, store, mesh, lines)
        torch.cuda.empty_cache()
        ready_then_go(f"kstep_{kind}")  # the timings alone on the card
        # the CGAN (no kernel, no profiled window) after the DCGAN, whose
        # window stays the first of the process
        for kd in kinds:
            per_step = KSTEP_CONVT[kd]
            ms = {}
            # the WGAN-GP step (~0.35 s) takes fewer steps
            slow = kd == "wgan"
            turns = KSTEP_TURNS
            for name in turns:
                m = mesh if name == "group" else None
                for k in (1, LOOP_K):
                    steps = 4 if slow else 20
                    warm, n_timed = (2 if slow else 3, steps) if k == 1 \
                        else (2, steps // LOOP_K)
                    profiled = (name == "group" and k > 1 and per_step
                                and f"group K={k}" not in ms)
                    calls, multi, _ = kstep_setup(
                        kd, store, m, torch.bfloat16,
                        (warm + n_timed + 2 * profiled) * k, seed=91, k=k)
                    for c in calls[:warm]:
                        c()
                    torch.cuda.synchronize()
                    kernels.reset_launch_counts()
                    ms.setdefault(f"{name} K={k}", []).append(
                        round(time_calls(calls[warm:], k, n_timed), 3))
                    launches = dict(kernels.LAUNCHES)
                    check(launches.get("convt4x4s2_fused", 0)
                          == per_step * n_timed * k
                          and on_new_designs(launches,
                                             per_step * n_timed * k),
                          (kd, name, k, launches))
                    if name == "group":
                        launched += launches.get("convt4x4s2_fused", 0)
                    if profiled:
                        rest = calls[warm + n_timed:]
                        events, _ = warm_profile(rest[0], rest[1])
                        n_convt = sum(
                            "convt4x4s2" in e.name for e in events
                            if e.device_type == DeviceType.CUDA)
                        per = multi.launches_per_replay.get(
                            "convt4x4s2_fused", 0)
                        check(per == per_step * k and n_convt == per,
                              (kd, per, n_convt))
                        launched += per
                        lines.append(
                            f"{kd}: the dispatcher counts {per} ConvT "
                            f"launches per replay of K={k} DP steps; the "
                            f"profiler sees {n_convt} ConvT kernels in "
                            f"one replay")
            lines.append(
                f"{kd}-224 B={KSTEP_B[kd]} bf16 ms per step (turns "
                f"{', '.join(turns)}): " + "; ".join(
                    f"{key} {v}" for key, v in sorted(ms.items()))
                + f" [{smi}]")
    finally:
        shutdown(mesh)
    print("\n".join(lines))
    return [launched]


def zero1_nets(kind: str, dev, mesh, seed: int, sharded: bool):
    """f32 DCGAN (``kind`` ``dcgan``) or unfrozen ResNet-50 (``clf``, with
    :func:`dist_classifier`'s synthetic store) tied to ``mesh``, and its
    optimizers, ZeRO-1 at the CLI's rule when ``sharded``. Returns (nets,
    optimizers, the synthetic store or None)."""
    from xgan_torch.models.layers import sync_batch_norm
    from xgan_torch.parallel.tp import shard_opt_state
    from xgan_torch.train.classifier import classifier_optimizer
    synth = None
    if kind == "dcgan":
        g, d, og, od = gan_models(torch.float32, seed=seed)
        nets, opts = (g, d), [og, od]
    else:
        model, _, synth = dist_classifier(dev, mesh, torch.float32, seed)
        nets, opts = (model,), [classifier_optimizer(model, 1e-3, False)]
    for net in nets:
        sync_batch_norm(net, mesh)
    if sharded:
        opts = [shard_opt_state(o, [n], mesh) for o, n in zip(opts, nets)]
    return nets, opts, synth


def phase_zero(train, smi: str, rank: int) -> list:
    """ZeRO-1 and the fold groups on two ranks sharing the card over
    gloo (``--phase zero/RANK``), f32 with TF32 off and deterministic
    cuDNN:

    - the DCGAN-224 (B = 16) and unfrozen-ResNet-50 (mix, B = 16)
      parameters after 3 steps with ZeRO-1 (the CLI's rule, 256 wide)
      bitwise equal to replicated Adam on the same ranks; the bytes of
      every tensor of the optimizers' state this rank keeps between
      steps both ways (``state_bytes``: the moments and step counts), and
      the most memory the 3 steps allocated above what was allocated
      before them (``torch.cuda.max_memory_allocated``: activations,
      gradients, the state, and ZeRO-1's dense copies and all-gather
      buckets);
    - this rank's share of a (3, 16) lockstep batch (one fold group of
      both ranks: 8 rows of each fold) through one fold-batched
      ``mixed_gather`` launch, bitwise the plain version's on the same
      rows.

    Saves its parameters for the parent's check that the ranks agree;
    returns its [ConvT, mixed_gather] launches."""
    from xgan_torch import kernels
    from xgan_torch.data.pipeline import DeviceStore
    from xgan_torch.kernels.gather import (mixed_gather, mixed_gather_ref,
                                           new_error_flag, raise_if_flagged)
    from xgan_torch.parallel.mesh import init_from_env, shutdown
    from xgan_torch.parallel.tp import state_bytes
    from xgan_torch.train.classifier import train_step
    from xgan_torch.train.gan import dcgan_step
    from xgan_torch.train.parallel_cv import FoldLayout
    from xgan_torch.train.parallel_folds import _pick
    mesh = init_from_env(cpu=False, backend="gloo")
    dev = mesh.device
    check(mesh.world == 2 and mesh.rank == rank, mesh)
    torch.backends.cudnn.deterministic = True
    store = DeviceStore(train, dev)
    out, nbytes, peak, launched = {}, {}, {}, [0, 0]
    try:
        b = 16
        idx, use, pick, flip = dist_draws(dev, b, 95)
        for kind in ("dcgan", "clf"):
            for sharded in (False, True):
                nets, opts, synth = zero1_nets(kind, dev, mesh, 96, sharded)
                gen = torch.Generator(dev).manual_seed(97)
                kernels.reset_launch_counts()
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats(dev)
                before = torch.cuda.memory_allocated(dev)
                for _ in range(3):
                    if kind == "dcgan":
                        dcgan_step(*nets, *opts, store.images, idx,
                                   latent_dim=LATENT, generator=gen,
                                   mesh=mesh)
                    else:
                        train_step(nets[0], opts[0], store, synth, idx,
                                   mode="mix", ratio=0.5, flip=flip,
                                   use_synth=use, synth_pick=pick,
                                   mesh=mesh)
                torch.cuda.synchronize()
                peak[kind, sharded] = (torch.cuda.max_memory_allocated(dev)
                                       - before)
                launched[0] += kernels.LAUNCHES["convt4x4s2_fused"]
                launched[1] += kernels.LAUNCHES["mixed_gather"]
                out[kind, sharded] = {
                    f"{i}.{k}": v.detach().clone()
                    for i, n in enumerate(nets)
                    for k, v in n.state_dict().items()}
                nbytes[kind, sharded] = sum(state_bytes(o) for o in opts)
                del nets, opts, synth
        for kind in ("dcgan", "clf"):
            plain, zero = out[kind, False], out[kind, True]
            check(all(torch.equal(zero[k], v) for k, v in plain.items()),
                  f"{kind}: ZeRO-1 parameters differ from replicated Adam")
            check(nbytes[kind, True] < 0.75 * nbytes[kind, False],
                  (kind, nbytes))

        layout = FoldLayout(mesh, 3)
        g = torch.Generator(dev).manual_seed(99)
        fidx = torch.randint(0, len(store), (3, b), generator=g, device=dev)
        fuse = torch.rand((3, b), generator=g, device=dev) < 0.5
        fpick = torch.randint(0, len(store), (3, b), generator=g, device=dev)
        rows = layout.group.local_rows(b)
        parts = [_pick(t, layout.folds, rows) for t in (fidx, fpick, fuse)]
        err = new_error_flag(dev)
        kernels.reset_launch_counts()
        mine = mixed_gather(store.images, store.images, *parts, err)
        check(kernels.LAUNCHES["mixed_gather"] == 1, dict(kernels.LAUNCHES))
        raise_if_flagged(err)
        launched[1] += 1
        check(torch.equal(mine, mixed_gather_ref(store.images, store.images,
                                                 *parts)),
              "the rank's fold-batched gather differs from the plain one")
        torch.save({f"{k[0]}_{k[1]}": v for k, v in out.items()},
                   os.path.join(CHILD_TMP, f"zero_rank{rank}.pt"))
    finally:
        shutdown(mesh)
    print(f"rank {rank} of 2 (gloo, one card), f32: ZeRO-1 parameters after "
          f"3 steps bitwise the replicated Adam's (DCGAN-224 B=16, "
          f"ResNet-50 unfrozen mix B=16); bytes of the optimizers' state "
          f"on this rank, replicated -> ZeRO-1: DCGAN "
          f"{nbytes['dcgan', False]} -> {nbytes['dcgan', True]}, ResNet-50 "
          f"{nbytes['clf', False]} -> {nbytes['clf', True]}; most bytes "
          f"the 3 steps allocated above their start, replicated -> ZeRO-1: "
          f"DCGAN {peak['dcgan', False]} -> {peak['dcgan', True]}, "
          f"ResNet-50 {peak['clf', False]} -> {peak['clf', True]}; its "
          f"(3 folds x {b // 2} rows) share of "
          f"a lockstep batch in one fold-batched mixed_gather launch, "
          f"bitwise the plain version [{smi}]")
    return launched


# name -> (k, the flags of the run): k = 3 accumulates two microbatches
A14_3_CLF = {"k2": (2, ()), "k3": (3, ("--grad-accum", "2"))}


def a14_3_processes(tmp: str, root: str, synth_dir: str) -> dict:
    """The CLI processes of :func:`phase_a14_3`, all started at once (f32,
    TF32 off, deterministic cuDNN): for k = 2 and 3, the classifier with
    ``--parallel-folds`` (ResNet-50, augmented, B = 16, 2 steps; k = 3
    with ``--grad-accum 2``, each rank's share of each microbatch) with no
    group, under a world-1 NCCL launch and as two gloo ranks on the card;
    the DCGAN with ``--steps-per-call 4`` (B = 128, 2 epochs of one K = 4
    call: the eager one, then the captured replay) with no group and
    under a world-1 NCCL launch with ``--shard-opt-state``; and
    the DCGAN at ``--steps-per-call 2`` as a gloo launch, which must
    refuse. Returns (run, part) -> process."""
    procs = {}
    ports = iter(free_ports(8))

    def clf_argv(name, k, extra):
        d = os.path.join(tmp, "a14_3", name)
        return ["--data-dir", root, "--synthetic-dir", synth_dir,
                "--use-synthetic", "--k-folds", str(k), "--parallel-folds",
                "--epochs", "1", "--limit-batches", "2",
                "--model-dir", os.path.join(d, "m"),
                "--results-dir", os.path.join(d, "metrics"),
                "--figures-dir", os.path.join(d, "figures"),
                "--cache-dir", os.path.join(tmp, "cache"), "--workers", "8",
                "--image-size", str(SIZE), "--batch-size", "16",
                "--compute-dtype", "f32", *extra]

    for name, (k, extra) in A14_3_CLF.items():
        procs[f"{name}_plain", 0] = dp_cli("train_classifier",
                                           clf_argv(f"{name}_plain", k,
                                                    extra), None)
        procs[f"{name}_nccl", 0] = dp_cli("train_classifier",
                                          clf_argv(f"{name}_nccl", k, extra),
                                          next(ports))
        port = next(ports)
        for r in range(2):
            procs[f"{name}_gloo", r] = subprocess.Popen(
                [sys.executable, "-u", "-c", CLI_LAUNCHER,
                 "train_classifier", *clf_argv(f"{name}_gloo", k, extra),
                 "--dist-backend", "gloo"], stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True, cwd=HERE,
                env=launch_env(r, 2, 0, port))
    for name, port, extra in (("gan_plain", None, []),
                              ("gan_zero", next(ports),
                               ["--shard-opt-state"])):
        procs[name, 0] = dp_cli("train_gan", gan_cli_argv(
            tmp, root, os.path.join(tmp, "a14_3", name), "--epochs", "2",
            "--limit-batches", "4", "--compute-dtype", "f32",
            "--steps-per-call", str(LOOP_K), *extra), port)
    procs["gloo_k2", 0] = subprocess.Popen(
        [sys.executable, "-u", "-c", CLI_LAUNCHER, "train_gan",
         *gan_cli_argv(tmp, root, os.path.join(tmp, "a14_3", "gloo_k2"),
                       "--steps-per-call", "2", "--dist-backend", "gloo")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        cwd=HERE, env=launch_env(0, 1, 0, next(ports)))
    return procs


def drain_all(procs: dict) -> dict:
    """Each process's (exit code, output), waited for in turn (600 s
    each); one still running then is killed."""
    res = {}
    for key, proc in procs.items():
        try:
            text = proc.communicate(timeout=600)[0]
        finally:
            if proc.poll() is None:
                proc.kill()
        res[key] = (proc.returncode, text)
    return res


def phase_a14_3(tmp: str, root: str, synth_dir: str, smi: str,
                held=None, others: dict | None = None) -> list:
    """A14 part 3 on the card: the CLI runs of :func:`a14_3_processes`
    (the classifier's parallel folds under a launch against no group: the
    same files, every JSON within 1e-4 * (1 + |ref|); the K = 4 DCGAN
    under NCCL with ZeRO-1 against no group: the first step within 1e-4 *
    (1 + |ref|), every step within 5e-2, the same launches; the gloo
    launch at K = 2 exits 1 with an ``Error:`` line that names NCCL) and,
    while they run, ZeRO-1 on two gloo ranks (:func:`phase_zero`, both
    ranks' parameters bitwise equal); then the DP K-step phases
    (:func:`phase_kstep_dp`, one process each), started once the ZeRO-1
    ranks end: their f32 holds beside the CLIs and the held TP steps,
    their timings each alone on the card (:func:`ready_then_go`).
    ``held``: phase 26's
    processes started beside its CLIs (:func:`start_tp`), waited for
    until they are ready, idle, before the timed phases. ``others``:
    more processes started beside its CLIs (phase 26's part 5 CLIs),
    drained in place into their (exit code, output) before the timed
    phases. Returns the (ConvT, mixed_gather) launches."""
    procs = a14_3_processes(tmp, root, synth_dir)
    procs.update({("others", key): p for key, p in (others or {}).items()})
    launched = [0, 0]
    ksteps = {}
    try:
        # the two ZeRO-1 ranks share the card with the CLIs: none is timed
        got = in_fresh_ranks("zero", 2, tmp, smi)
        launched = [got[0][0] + got[1][0], got[0][1] + got[1][1]]
        ranks = [torch.load(os.path.join(tmp, f"zero_rank{r}.pt"),
                            weights_only=True) for r in range(2)]
        check(all(torch.equal(v, ranks[1][n][k]) for n in ranks[0]
                  for k, v in ranks[0][n].items()),
              "the two ranks' parameters differ")
        # the K-step phases' f32 holds beside the CLIs' and the held TP
        # steps' last seconds (each once the card has KSTEP_FREE free);
        # their timings later, each alone on the card
        ksteps = {kind: start_fresh_ranks(f"kstep_{kind}", 1, tmp, smi)
                  for kind in ("dcgan", "wgan")}
        res = drain_all(procs)
        if others is not None:
            others.update({key[1]: res.pop(key) for key in list(res)
                           if key[0] == "others"})
        for part, started in (held or {}).items():
            wait_ready(tmp, f"tp{part}", started[1])
        rc, text = res["gloo_k2", 0]
        last = text.strip().splitlines()[-1] if text.strip() else ""
        check(rc == 1 and last.startswith("Error: --steps-per-call 2")
              and "NCCL" in last, (rc, text[-2000:]))
        for key, (rc, text) in res.items():
            if key[0] == "gloo_k2":
                continue
            check(rc == 0, f"{key}: exit {rc}\n" + text[-3000:])

        def launches(key):
            last = res[key][1].strip().splitlines()[-1]
            check(last.startswith("LAUNCHES "), last)
            return json.loads(last[len("LAUNCHES "):])

        def tree(name):
            top = os.path.join(tmp, "a14_3", name)
            files = sorted(os.path.relpath(os.path.join(p, f), top)
                           for p, _, fs in os.walk(top) for f in fs)
            return top, files

        worst = {}
        for name, (k, _) in A14_3_CLF.items():
            top0, files0 = tree(f"{name}_plain")
            for run in ("nccl", "gloo"):
                top, files = tree(f"{name}_{run}")
                check(files == files0, (name, run, files, files0))
                w = 0.0
                for f in files0:
                    if f.endswith(".json"):
                        with open(os.path.join(top0, f)) as fh:
                            want = json.load(fh)
                        with open(os.path.join(top, f)) as fh:
                            got = json.load(fh)
                        w = max(w, f32_close(json_numbers(got),
                                             json_numbers(want)))
                check(w <= 1e-4, (name, run, w))
                worst[f"k={k} {run}"] = w
                got = sum(launches((f"{name}_{run}", r)).get(
                    "mixed_gather", 0) for r in range(1 + (run == "gloo")))
                check(got == 2 * (1 + (run == "gloo")), (name, run, got))
                launched[1] += got
            check("rank 1 trains folds" in res[f"{name}_gloo", 1][1]
                  or k != 2, res[f"{name}_gloo", 1][1][-2000:])
        h = {}
        for name in ("gan_plain", "gan_zero"):
            with open(os.path.join(tmp, "a14_3", name, "metrics",
                                   "gan_training_history.json")) as f:
                h[name] = json.load(f)
        per_step = [f32_close([h["gan_zero"][k][t] for k in GAN_ITER_KEYS],
                              [h["gan_plain"][k][t] for k in GAN_ITER_KEYS])
                    for t in range(len(h["gan_plain"]["G_losses_iter"]))]
        gl = [launches((n, 0)) for n in ("gan_plain", "gan_zero")]
        check(len(per_step) == 2 * LOOP_K and per_step[0] <= 1e-4
              and max(per_step) <= 5e-2 and gl[0] == gl[1]
              and gl[1].get("convt4x4s2_fused", 0) >= 5 * LOOP_K,
              (per_step, gl))
        check("rank 0 of 1" in res["gan_zero", 0][1], "no group joined")
        launched[0] += gl[1]["convt4x4s2_fused"]
    except BaseException:
        for _, ranks, _ in ksteps.values():
            for proc in ranks:
                proc.kill()
        raise
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
    print("A14 part 3 CLIs (f32, TF32 off, deterministic cuDNN): "
          "--parallel-folds against no group, worst |a-b|/(1+|b|) of every "
          "JSON number: " + ", ".join(f"{k} {v:.3g}" for k, v in
                                      worst.items())
          + " (limit 1e-4), the same files; the DCGAN at --steps-per-call "
          f"{LOOP_K} under world-1 NCCL with --shard-opt-state against no "
          "group, per step: " + ", ".join(f"{v:.3g}" for v in per_step)
          + " (limits: step 1 1e-4, all 5e-2); a gloo launch at K=2 exits "
          f"1 naming NCCL [{smi}]")
    failed = []
    try:
        for kind, started in ksteps.items():  # both done with the card
            wait_ready(tmp, f"kstep_{kind}", started[1])
        for kind, started in ksteps.items():  # the CGAN's with the DCGAN's
            try:
                go(tmp, f"kstep_{kind}")
                launched[0] += finish_fresh_ranks(started)[0][0]
            except AssertionError as e:  # the other phases still report
                failed.append(str(e)[-3000:])
    finally:
        for _, ranks, _ in ksteps.values():
            for proc in ranks:
                if proc.poll() is None:
                    proc.kill()
    check(not failed, "\n".join(failed))
    return launched


# A14 parts 4 and 5: tensor parallelism over two gloo ranks sharing the
# card
TP_N = 2  # --model-parallel: data 1 x model 2
TP_STEPS = 3  # the f32 steps held; the first of them held by its norms
# the floors of a held step (tp_held): name -> (the batch's rows rolled
# by this fraction of B, cuDNN on); "floor" takes every step (the
# parameters' floor), the others and the TF32 control one
TP_FLOORS = {"floor": (1 / 2, True), "floor_b4": (1 / 4, True),
             "algo": (0, False), "algo_b4": (1 / 4, False)}
ONE_STEP = (*list(TP_FLOORS)[1:], "tf32")
# the steps held under TP, by part: the DCGAN-224 (B = 128) and the
# unfrozen ResNet-50 (mix, B = 32); the WGAN-GP-224 (B = 64, 5 critic
# updates) and the CGAN-224 (B = 32, random VGG16, the gate open)
TP_CASES = {4: ("dcgan", "clf"), 5: ("wgan", "cgan")}
TP_LABEL = {"dcgan": "DCGAN", "clf": "ResNet-50", "wgan": "WGAN-GP",
            "cgan": "CGAN"}
# the held steps' batches: the WGAN-GP's at 32, not the trainer's 64 (its
# f32 TP steps over gloo cost the script's time limit too much); its bf16
# timings, the ConvT launches held and timed, and its CLI at 64
TP_B = {"dcgan": GAN_B, "clf": CLS_B, "wgan": WGAN_B // 2, "cgan": CGAN_B}
# the kernel each case launches, and its launches a step
TP_LAUNCHES = {"dcgan": ("convt4x4s2_fused", 5), "clf": ("mixed_gather", 1),
               "wgan": ("convt4x4s2_fused", 5 * (WGAN_CRITIC + 1)),
               "cgan": ("convt4x4s2_fused", 0)}
# parameter + Adam bytes a rank keeps over one rank's at N = 2 (counts
# from the shapes; shard_dims of the nets), by the nets' tags
TP_RATIOS = {"dcgan.g": 0.5651, "dcgan.d": 0.5339, "clf.c": 0.5208,
             "wgan.g": 0.5204, "wgan.d": 0.5287, "cgan.g": 0.9961,
             "cgan.d": 0.6434}
# the sliced k4s2 ConvT launches at N = 2, by part: (the case, H = W, Cin,
# Cout); held and timed at the trainers' B (GAN_B, WGAN_B)
TP_CONVT = {4: (("dcgan", 7, 8 * FG, 4 * FG // TP_N),),
            5: (("wgan", 7, 16 * FG, 8 * FG // TP_N),
                ("wgan", 14, 8 * FG, 4 * FG // TP_N))}
TP_TRAIN_B = {"dcgan": GAN_B, "wgan": WGAN_B, "cgan": CGAN_B}


def tp_rows(name: str, b: int, dev):
    """The rows of run ``name`` of a held step: the batch rolled by its
    floor's fraction, or all in order."""
    shift = int(TP_FLOORS.get(name, (0, True))[0] * b)
    return torch.arange(b, device=dev).roll(shift) if shift else slice(None)


def whole_grad_norms(*nets) -> dict:
    """Each parameter's whole gradient norm, by name: a slice's squared
    norm summed over its model group."""
    from xgan_torch.parallel import tp
    out = {}
    for i, net in enumerate(nets):
        for n, p in net.named_parameters():
            if p.grad is None:
                continue
            sq = p.grad.double().square().sum()
            if tp.sharded(p):
                p.tp_model.all_reduce_(sq)
            out[f"{i}.{n}"] = sq.sqrt().item()
    return out


@contextlib.contextmanager
def convt_shapes():
    """Records ``(x.shape, Cout)`` of every ConvT kernel launch made
    inside (the shapes the wrapper gave the kernel)."""
    from xgan_torch.kernels import convt as convt_mod
    seen, orig = [], convt_mod.convt4x4s2_fused_cuda

    def recorded(x, wp, *args, **kwargs):
        seen.append((tuple(x.shape), wp.shape[-1]))
        return orig(x, wp, *args, **kwargs)

    convt_mod.convt4x4s2_fused_cuda = recorded
    try:
        yield seen
    finally:
        convt_mod.convt4x4s2_fused_cuda = orig


def tp_params_close(a: dict, b: dict, floor: dict, steps: int,
                    lr: float) -> tuple:
    """(max |a - b|, elements outside rtol 2e-3 / atol 2e-5, elements, the
    floor's max and outside count) of two state dicts' float tensors
    after ``steps`` Adam steps from a warm state, where Adam may move a
    coordinate by more than lr a step: held at twice the floor (the
    reference over its rows in another order, rounding alone) or 2 lr a
    step, whichever is larger, and at most twice the floor's outside
    count plus 1 in 1000."""
    def diff(x):
        worst, outside, total = 0.0, 0, 0
        for k, v in b.items():
            if v.is_floating_point():
                d = (x[k].double() - v.double()).abs()
                worst = max(worst, d.max().item())
                outside += int((d > 2e-5 + 2e-3 * v.double().abs()).sum())
                total += v.numel()
        return worst, outside, total

    (worst, outside, total), (f_worst, f_out, _) = diff(a), diff(floor)
    ok = (worst <= max(2 * lr * steps, 2 * f_worst) + 1e-6
          and outside <= 2 * f_out + total // 1000)
    return worst, outside, total, f_worst, f_out, ok


def tp_held(label: str, runs: dict, lr: float, skip=(),
            adam_steps: int = TP_STEPS, control_metrics: bool = False
            ) -> dict:
    """The TP run against the one-rank reference (the DCGAN's and the
    classifier's with an all-ones mask, as :func:`dp_step_checks`; the
    WGAN-GP's and the CGAN's with none, as :func:`dp_family_checks`): the
    first step's metrics within 1e-4 * (1 + |ref|), its per-tensor
    gradient norms within 1e-3 plus twice the floor, the parameters after
    the steps by :func:`tp_params_close` (``adam_steps`` Adam updates of a
    parameter at most); the TF32 control's norms must fail those limits
    (with ``control_metrics``, its norms or its metrics, as
    :func:`dp_family_checks` holds the WGAN-GP's and the CGAN's).
    The floor of a norm is the largest of four rounding-only departures
    from the reference (``TP_FLOORS``): its rows in two other orders, and
    every convolution on another algorithm (cuDNN off), in order and
    rolled, as TP's sliced convolutions take other cuDNN algorithms than
    the whole ones and sum their rows in other orders. ``skip``: the
    norms not held (the CGAN's biases right before a BN, whose gradient is
    0 in exact arithmetic; a sliced one's whole norm too). ``runs``: name
    -> (metrics, grad norms, whole state). Returns the readings and
    ``failed``, the holds that failed (the caller prints the readings
    first)."""
    ref = runs["ref"][1]
    # one floor whose departure from ref is the largest of the floors'
    floor = {k: v + max(abs(runs[f][1][k] - v) for f in TP_FLOORS)
             for k, v in ref.items()}
    out = {"metrics": f32_close(runs["tp"][0], runs["ref"][0])}
    out["grads"] = grad_norms_ratio(runs["tp"][1], ref, floor, skip)
    out["tf32"] = grad_norms_ratio(runs["tf32"][1], ref, floor, skip)
    out["tf32_metrics"] = f32_close(runs["tf32"][0], runs["ref"][0])

    def rel(x, k):
        return abs(x[k] - ref[k]) / max(ref[k], 1e-30)

    held = [k for k in ref if k not in skip]
    out["worst"] = sorted(((rel(runs["tp"][1], k), rel(floor, k), k)
                           for k in held), reverse=True)[:4]
    out["median"] = [statistics.median(rel(runs[r][1], k) for k in held)
                     for r in ("tp", *TP_FLOORS)]
    out["params"] = tp_params_close(runs["tp"][2], runs["ref"][2],
                                    runs["floor"][2], adam_steps, lr)
    control = out["tf32"] > 1.0 or (control_metrics
                                     and out["tf32_metrics"] > 1e-4)
    out["failed"] = [what for what, ok in (
        ("metrics", out["metrics"] <= 1e-4), ("norms", out["grads"] <= 1.0),
        ("TF32 control", control), ("params", out["params"][-1]))
        if not ok]
    return out


def phase_tp(train, smi: str, rank: int, part: int) -> list:
    """One rank of two sharing the card over gloo with ``--model-parallel
    2`` for A14 part ``part`` (``--phase tp4/RANK``, ``tp5/RANK``):
    :func:`tp_holds`, then, once the parent writes ``tp{part}_go`` into
    the temporary directory (nothing else then runs on the card),
    :func:`tp_timings`. Between the two it writes
    ``tp{part}_ready{RANK}`` and waits with its cached memory given back.
    Returns its [ConvT, mixed_gather] launches."""
    from xgan_torch.parallel.mesh import init_from_env, shutdown
    world = init_from_env(cpu=False, backend="gloo")
    try:
        data, model = world.split_model(TP_N)
        check(world.world == 2 and world.rank == rank and data.world == 1
              and model.rank == rank, (world, data, model))
        held = tp_holds(world, data, train, smi, rank, part)
        torch.cuda.empty_cache()
        ready_then_go(f"tp{part}", rank)
        timed = tp_timings(world, data, train, smi, rank, part)
    finally:
        shutdown(world)
    return [a + b for a, b in zip(held, timed)]


def ready_then_go(name: str, rank: int = 0) -> None:
    """In a ``--phase`` process: writes ``{name}_ready{rank}`` into the
    temporary directory, then waits (900 s at most) for the parent's
    ``{name}_go`` (:func:`go`), written once nothing else runs on the
    card."""
    with open(os.path.join(CHILD_TMP, f"{name}_ready{rank}"), "w"):
        pass
    path = os.path.join(CHILD_TMP, f"{name}_go")
    deadline = time.time() + 900
    while not os.path.exists(path):
        check(time.time() < deadline, f"no {name}_go in 900 s")
        time.sleep(0.2)


def wait_ready(tmp: str, name: str, procs) -> None:
    """Waits until each rank of ``procs`` has written its
    ``{name}_ready{RANK}`` file (:func:`ready_then_go`) or ended (its
    failure is read later); a process after the ranks (a TP part's
    reference, :func:`phase_tp_ref`), which writes none, until it has
    ended."""
    deadline = time.time() + 600
    for r, p in enumerate(procs):
        while not os.path.exists(os.path.join(tmp, f"{name}_ready{r}")) \
                and p.poll() is None:
            check(time.time() < deadline, f"{name} never got ready")
            time.sleep(0.2)


def go(tmp: str, name: str) -> None:
    """Lets the processes waiting in :func:`ready_then_go` on ``name``
    go on."""
    with open(os.path.join(tmp, f"{name}_go"), "w"):
        pass


# card bytes free before a K-step phase starts its f32 holds beside the
# phase's other processes
KSTEP_FREE = 30 * 2**30


@contextlib.contextmanager
def card_turn(free: int, timeout: float = 300):
    """Waits, holding the ``card.lock`` file of the temporary directory,
    until the card has ``free`` bytes free (the script's other processes
    share it; ``timeout`` s at most), and keeps the lock while the block
    runs, so that the blocks of two processes never share the free bytes.
    Prints what it found."""
    import fcntl
    with open(os.path.join(CHILD_TMP, "card.lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        t0 = time.time()
        while torch.cuda.mem_get_info()[0] < free \
                and time.time() - t0 < timeout:
            time.sleep(0.5)
        print(f"{torch.cuda.mem_get_info()[0] / 2**30:.1f} GiB of the card "
              f"free after {time.time() - t0:.1f} s (wanted "
              f"{free / 2**30:.0f} GiB)")
        try:
            yield
        finally:
            torch.cuda.synchronize()
            fcntl.flock(lock, fcntl.LOCK_UN)


def tp_nets(kind: str, mesh, warm=None, dtype=torch.float32):
    """The nets of case ``kind`` at full width, seeded: the DCGAN's G and
    D (seed 60), the WGAN-GP's G and critic (70), the CGAN's G and D and
    random VGG16 features (72), or a ResNet-50 with ``--unfreeze``'s Adam
    (63); ``warm``'s weights and Adam state (whole; copied) when given;
    tied to ``mesh`` and, when it has one, placed over its model group
    (never the VGG16, which stays whole as the trainer keeps it). Returns
    (the step's nets, [(tag, module, its Adam)])."""
    import copy
    from xgan_torch.models.layers import sync_batch_norm
    from xgan_torch.parallel import tp
    from xgan_torch.train.common import adam
    dev = torch.device("cuda")
    if kind == "clf":
        from xgan_torch.models.resnet import ResNet50
        from xgan_torch.train.classifier import classifier_optimizer
        net = ResNet50(2, dtype=dtype, device=dev,
                       generator=torch.Generator(device=dev).manual_seed(63))
        sync_batch_norm(net, mesh)
        if mesh is not None:
            tp.shard_over_model([net], mesh.model)
        opt = classifier_optimizer(net, 1e-3, False)
        return (net, opt), [("c", net, opt)]
    vgg = None
    if kind == "dcgan":
        g, d, _, _ = gan_models(dtype, seed=60)
    elif kind == "wgan":
        g, d, _, _ = wgan_models(dtype, seed=70)
    else:
        g, d, vgg, _, _ = cgan_models(dev, dtype, seed=72)
    if warm is not None:
        warm = copy.deepcopy(warm)
        g.load_state_dict(warm[0])
        d.load_state_dict(warm[1])
    sync_batch_norm(g, mesh)
    sync_batch_norm(d, mesh)
    if mesh is not None:
        tp.shard_over_model([g, d], mesh.model)
    b2 = 0.9 if kind == "wgan" else 0.999
    og, od = (adam(m.parameters(), 2e-4, 0.5, b2) for m in (g, d))
    for o, sd in zip((og, od), warm[2:] if warm is not None else ()):
        o.load_state_dict(tp.opt_state_for_load(o, sd))
    return (g, d, vgg, og, od), [("g", g, og), ("d", d, od)]


def tp_draws(kind: str, n: int, b: int | None = None) -> list:
    """``n`` seeded steps' batches (of ``b`` rows, default the case's
    ``TP_B``) and draws of case ``kind``: the
    DCGAN's (idx, flip, noise), the classifier's (idx, use_synth, pick,
    flip), the WGAN-GP's (idx, flip, critic noises, alphas, G's noise),
    the CGAN's (idx, flip, noise, fake labels, real targets, fake
    targets)."""
    dev = torch.device("cuda")
    if kind == "clf":
        return [dist_draws(dev, CLS_B, 62 + t) for t in range(n)]
    b = b or TP_B[kind]
    gen = torch.Generator(device=dev).manual_seed(
        {"dcgan": 61, "wgan": 90, "cgan": 91}[kind])

    def unif(*shape):
        return torch.rand(shape, generator=gen, device=dev)

    def normal(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    out = []
    for _ in range(n):
        idx = torch.randint(0, N_TRAIN, (b,), generator=gen, device=dev)
        if kind == "dcgan":
            out.append((idx, unif(b) < 0.5, normal(b, LATENT)))
        elif kind == "wgan":
            out.append((idx, unif(b) < 0.5,
                        [normal(b, LATENT) for _ in range(WGAN_CRITIC)],
                        [unif(b, 1, 1, 1) for _ in range(WGAN_CRITIC)],
                        normal(b, LATENT)))
        else:
            out.append((idx, unif(b) < 0.5, normal(b, LATENT),
                        torch.randint(0, 2, (b,), generator=gen, device=dev),
                        0.9 - 0.1 * unif(b), 0.1 + 0.1 * unif(b)))
    return out


def tp_step(kind: str, nets, stores, draw, rows=slice(None), mesh=None,
            mask=None) -> list:
    """One step of case ``kind`` on ``nets`` (:func:`tp_nets`) with
    ``draw``'s rows ``rows`` (the CGAN's at epoch 0: the gate open);
    ``stores``: the train store and the classifier's synthetic store.
    Returns its metrics (the classifier's per-sample losses)."""
    from xgan_torch.train.cgan import cgan_step
    from xgan_torch.train.classifier import train_step
    from xgan_torch.train.gan import dcgan_step
    from xgan_torch.train.wgan import wgan_step
    store, synth = stores

    def r(t):
        return [x[rows] for x in t] if isinstance(t, list) else t[rows]

    if kind == "clf":
        net, opt = nets
        idx, use, pick, flip = draw
        return train_step(net, opt, store, synth, r(idx), mode="mix",
                          ratio=0.5, flip=r(flip), use_synth=r(use),
                          synth_pick=r(pick), mask=mask,
                          mesh=mesh)[0].tolist()
    g, d, vgg, og, od = nets
    if kind == "dcgan":
        idx, flip, noise = draw
        out = dcgan_step(g, d, og, od, store.images, r(idx),
                         latent_dim=LATENT, flip=r(flip), noise=r(noise),
                         mask=mask, mesh=mesh)
    elif kind == "wgan":
        idx, flip, noises, alphas, g_noise = draw
        out = wgan_step(g, d, og, od, store.images, r(idx),
                        latent_dim=LATENT, critic_iters=WGAN_CRITIC,
                        lambda_gp=10.0, flip=r(flip), noises=r(noises),
                        alphas=r(alphas), g_noise=r(g_noise), mask=mask,
                        mesh=mesh)
    else:
        idx, flip, noise, fake_labels, real_t, fake_t = draw
        out = cgan_step(g, d, vgg, og, od, store.images, store.labels,
                        r(idx), 0, latent_dim=LATENT, flip=r(flip),
                        noise=r(noise), fake_labels=r(fake_labels),
                        real_targets=r(real_t), fake_targets=r(fake_t),
                        mask=mask, mesh=mesh)
    return out.tolist()


def tp_stores(train, dev):
    """The train store on ``dev`` and the classifier's seeded 256-image
    synthetic store."""
    from xgan_torch.data.pipeline import DeviceStore
    from xgan_torch.data.store import ImageStore
    rng = np.random.default_rng(63)
    return DeviceStore(train, dev), DeviceStore(ImageStore(
        rng.integers(0, 256, (256, SIZE, SIZE, 3), np.uint8),
        np.ones(256, np.int32), SIZE), dev)


def tp_run(kind: str, name: str, nets, tagged, stores, draws, mesh,
           rows=slice(None), mask=None, shapes=None) -> tuple:
    """Run ``name`` of case ``kind``: its held steps (one for the floors
    after the first and the TF32 control), each kernel launch counted;
    returns (the first step's metrics, its whole gradient norms, the
    whole state after the steps on the host). ``shapes``: a list that
    takes every ConvT launch shape."""
    from xgan_torch import kernels
    from xgan_torch.parallel import tp
    kernels.reset_launch_counts()
    with convt_shapes() as seen:
        metrics, norms = [], None
        for draw in draws[:1 if name in ONE_STEP else None]:
            metrics.append(tp_step(kind, nets, stores, draw, rows, mesh,
                                   mask))
            if norms is None:
                norms = whole_grad_norms(*(m for _, m, _ in tagged))
        torch.cuda.synchronize()
    key, per_step = TP_LAUNCHES[kind]
    check(kernels.LAUNCHES[key] == per_step * len(metrics),
          (kind, name, dict(kernels.LAUNCHES)))
    if shapes is not None:
        shapes += seen
    state = {f"{tag}.{k}": v.cpu().clone() for tag, m, _ in tagged
             for k, v in tp.whole_state_dict(m).items()}
    return metrics[0], norms, state


def tp_warm(kind: str, stores):
    """The 3 warm-up steps of case ``kind`` on one rank (bf16; none for
    the classifier, which steps from its seeded weights): G's and D's
    weights and Adam state after them."""
    if kind == "clf":
        return None
    nets, _ = tp_nets(kind, None, dtype=torch.bfloat16)
    for draw in tp_draws(kind, 3 + TP_STEPS)[:3]:
        tp_step(kind, nets, stores, draw)
    g, d, _, og, od = nets
    return [x.state_dict() for x in (g, d, og, od)]


def phase_tp_ref(train, smi: str, run: int, part: int) -> list:
    """The one-rank side of A14 part ``part``'s holds (``--phase tp4ref``,
    ``tp5ref``), in a process of its own beside the part's TP ranks, f32
    with TF32 off and deterministic cuDNN: first each case's 3
    warm-up steps (bf16), written as ``tp_warm_{kind}.pt`` for the TP
    ranks and its own runs to start from; then each case's reference and
    the four floors of :func:`tp_held` (``ref`` and ``floor`` 3 steps,
    the others 1), written as ``tp_ref_{kind}.pt`` (name -> (the first
    step's metrics, its whole gradient norms, the whole state after the
    steps), and each net's parameter and Adam bytes). The DCGAN's and the
    classifier's one-rank steps take the all-ones mask of
    :func:`dp_step_checks` (BN's sums path), the WGAN-GP's and the CGAN's
    none (``F.batch_norm``, as :func:`dp_family_checks`). Returns no
    launches (the references' are not the main path's)."""
    from xgan_torch.parallel import tp
    dev = torch.device("cuda")
    stores = tp_stores(train, dev)
    torch.backends.cudnn.deterministic = True
    warm = {}
    for kind in TP_CASES[part]:
        warm[kind] = tp_warm(kind, stores)
        save_whole(warm[kind], os.path.join(CHILD_TMP, f"tp_warm_{kind}.pt"))
    try:
        for kind in TP_CASES[part]:
            draws = tp_draws(kind, 3 + TP_STEPS)[3:]
            mask = torch.ones(TP_B[kind], device=dev) \
                if kind in ("dcgan", "clf") else None
            out = {}
            for name in ("ref", *TP_FLOORS):
                torch.backends.cudnn.enabled = \
                    TP_FLOORS.get(name, (0, True))[1]
                nets, tagged = tp_nets(kind, None, warm[kind])
                out[name] = tp_run(kind, name, nets, tagged, stores, draws,
                                   None, tp_rows(name, TP_B[kind], dev),
                                   mask)
                if name == "ref":
                    out["bytes"] = {f"{kind}.{tag}": tp.rank_bytes([m], [o])
                                    for tag, m, o in tagged}
                del nets, tagged
            save_whole(out, os.path.join(CHILD_TMP, f"tp_ref_{kind}.pt"))
            print(f"{TP_LABEL[kind]}: the one-rank reference and its floors "
                  f"{list(TP_FLOORS)} written")
    finally:
        torch.backends.cudnn.enabled = True
        torch.backends.cudnn.deterministic = False
    return [0, 0]


def tp_holds(world, data, train, smi: str, rank: int, part: int) -> list:
    """One rank of two sharing the card over gloo with ``--model-parallel
    2`` (data 1 x model 2; ``world`` and its data group), f32 with TF32
    off and deterministic cuDNN, against one rank on the same inputs
    (:func:`phase_tp_ref`, a process of its own), for the cases of A14
    part ``part`` (``TP_CASES``):

    - 3 steps of each case from the reference's warm-up state and the
      TF32 control's one step; on rank 0 :func:`tp_held` of each (the
      first step's metrics, its norms against the floor of four
      rounding-only runs, the TF32 control, the parameters after 3
      steps; the CGAN's biases right before a BN not held, G's sliced
      ``fc.bias`` by its whole norm);
    - every ConvT launch shape of the TP steps recorded: each sliced k4s2
      layer of ``TP_CONVT`` launched once a G forward (DCGAN: (128, 7, 7,
      512) -> 128; WGAN-GP: (32, 7, 7, 1024) -> 256 and (32, 14, 14, 512)
      -> 128, 6 G forwards a step);
    - those layers' launches at the trainers' batch held against the
      plain version in bf16 and f32 (``TOL``; timed by
      :func:`tp_timings`);
    - the bytes of the parameters and Adam state this rank keeps of each
      net against one rank's (counts from the shapes; ``TP_RATIOS``).

    Before the WGAN-GP's TP steps rank 0 alone runs a one-rank WGAN-GP
    step, so that the ranks' autograd histories differ: the penalty's
    double backward must issue its collectives in one order all the same
    (``xgan_torch.parallel.tp.one_autograd_thread``).
    Saves its parameters and slices' names (``tp{part}_rank{RANK}.pt``)
    for the parent's check of the replicated leaves; returns its [ConvT,
    mixed_gather] launches."""
    from xgan_torch import kernels
    from xgan_torch.kernels.convt import (convt4x4s2_fused,
                                          convt4x4s2_fused_ref,
                                          pack_convt_weight)
    from xgan_torch.models.cgan import D_PRE_BN_BIASES, G_PRE_BN_BIASES
    from xgan_torch.parallel import tp
    dev = world.device
    torch.backends.cudnn.deterministic = True
    stores = tp_stores(train, dev)
    launched, runs, nbytes, shapes = [0, 0], {}, {}, []
    local, sliced, errs = {}, [], {}
    try:
        for kind in TP_CASES[part]:
            draws = tp_draws(kind, 3 + TP_STEPS)[3:]
            warm = None if kind == "clf" else torch.load(wait_file(
                os.path.join(CHILD_TMP, f"tp_warm_{kind}.pt")),
                weights_only=True)
            runs[kind] = {}
            if kind == "wgan" and rank == 0:
                # autograd work of this rank's own first (a one-rank step,
                # its penalty's double backward): the TP steps' model-group
                # collectives must keep their order all the same
                lone, _ = tp_nets(kind, None, warm)
                tp_step(kind, lone, stores, draws[0])
                del lone
            for name in ("tp", "tf32"):
                torch.backends.cuda.matmul.allow_tf32 = name == "tf32"
                torch.backends.cudnn.allow_tf32 = name == "tf32"
                nets, tagged = tp_nets(kind, data, warm)
                runs[kind][name] = tp_run(
                    kind, name, nets, tagged, stores, draws, data,
                    shapes=shapes if name == "tp" else None)
                if name == "tp":
                    key, per_step = TP_LAUNCHES[kind]
                    launched[key == "mixed_gather"] += per_step * TP_STEPS
                    for tag, m, o in tagged:
                        nbytes[f"{kind}.{tag}"] = tp.rank_bytes([m], [o])
                        local.update({f"{kind}.{tag}.{k}": v.clone()
                                      for k, v in m.state_dict().items()})
                        sliced += [f"{kind}.{tag}.{k}" for k in m.tp_dims]
                del nets, tagged
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
        torch.save({"local": local, "sliced": sliced},
                   os.path.join(CHILD_TMP, f"tp{part}_rank{rank}.pt"))
        # each sliced launch a G forward: 1 a DCGAN step, 6 a WGAN-GP one
        for kind, hw, cin, cout in TP_CONVT[part]:
            forwards = 1 if kind == "dcgan" else WGAN_CRITIC + 1
            check(shapes.count(((TP_B[kind], hw, hw, cin), cout))
                  == forwards * TP_STEPS, (hw, cin, cout, shapes))
            b = TP_TRAIN_B[kind]
            gk = torch.Generator(device=dev).manual_seed(74 + hw + cin)
            x32 = torch.randn(b, hw, hw, cin, generator=gk, device=dev)
            w = torch.randn(cin, cout, 4, 4, generator=gk, device=dev) \
                / math.sqrt(4 * cin)
            ones_o = torch.ones(cout, device=dev)
            zeros_o = torch.zeros(cout, device=dev)
            for dtype in (torch.float32, torch.bfloat16):
                x, wp = x32.to(dtype), pack_convt_weight(w, dtype)
                kernels.reset_launch_counts()
                y = convt4x4s2_fused(x, wp, ones_o, zeros_o, act="none")
                check(kernels.LAUNCHES["convt4x4s2_fused"] == 1,
                      dict(kernels.LAUNCHES))
                ref = convt4x4s2_fused_ref(x, wp, ones_o, zeros_o,
                                           act="none")
                err = (y.float() - ref.float()).abs().max().item()
                # the limits of phase_kernels: TOL of (1 + max |ref|)
                tol = TOL[dtype] * (1 + ref.float().abs().max().item())
                check(err <= tol, (hw, cin, cout, dtype, err, tol))
                errs[f"({b}, {hw}, {hw}, {cin}) -> {cout}", dtype] = err
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cudnn.deterministic = False
    print(f"rank {rank}: G's sliced ConvTs launched once a G forward "
          f"({TP_STEPS} held steps); at x " + "; ".join(
              sorted({s for s, _ in errs})) + " held against the plain "
          "version (limits TOL of 1 + max |ref|): "
          "max |err| " + ", ".join(
              f"{s} {'f32' if dt == torch.float32 else 'bf16'} {e:.3g}"
              for (s, dt), e in errs.items()) + f" [{smi}]")
    if rank:
        return launched

    def params(p):
        return (f"max {p[0]:.3g} ({p[1]} of {p[2]} outside 2e-5 + 2e-3 "
                f"|ref|; the floor {p[3]:.3g}, {p[4]})")

    skip = {f"0.{k}" for k in G_PRE_BN_BIASES} \
        | {f"1.{k}" for k in D_PRE_BN_BIASES}
    failed = []
    for kind in TP_CASES[part]:
        ref = torch.load(wait_file(os.path.join(
            CHILD_TMP, f"tp_ref_{kind}.pt")), weights_only=True)
        for key, one in ref.pop("bytes").items():
            nbytes[key] /= one
        # Adam updates of a parameter in the held steps
        updates = TP_STEPS * (WGAN_CRITIC if kind == "wgan" else 1)
        r = tp_held(TP_LABEL[kind], {**runs[kind], **ref},
                    1e-3 if kind == "clf" else 2e-4,
                    skip if kind == "cgan" else (), updates,
                    kind in ("wgan", "cgan"))
        failed += [f"{kind} {what}" for what in r["failed"]]
        print(f"--model-parallel 2 (gloo, one card), f32 against one rank: "
              f"{TP_LABEL[kind]}-224 B={TP_B[kind]} metrics "
              f"{r['metrics']:.3g} (limit 1e-4), gradient norms "
              f"{r['grads']:.3f} of the limit (TF32 control {r['tf32']:.3f},"
              f" its metrics {r['tf32_metrics']:.3g}), params after "
              f"{TP_STEPS} steps {params(r['params'])}; its worst gradient "
              "norms (relative difference, the floor's): " + ", ".join(
                  f"{k} ({a:.3g}, {f:.3g})" for a, f, k in r["worst"])
              + "; the median relative difference of TP and of each floor "
              f"{list(TP_FLOORS)}: "
              + ", ".join(f"{v:.3g}" for v in r["median"]) + f" [{smi}]")
    print("per-rank parameter + Adam bytes over one rank's (counts): "
          + ", ".join(f"{k} {v:.4f}" for k, v in nbytes.items())
          + f" [{smi}]")
    check(not failed, failed)
    for k, v in nbytes.items():
        check(abs(v - TP_RATIOS[k]) <= 1e-3, (k, v, TP_RATIOS[k]))
    return launched


def wait_file(path: str, seconds: float = 900):
    """``path`` once it exists (written whole by :func:`save_whole`)."""
    deadline = time.time() + seconds
    while not os.path.exists(path):
        check(time.time() < deadline, f"no {path} in {seconds} s")
        time.sleep(0.2)
    return path


def save_whole(obj, path: str) -> None:
    """``torch.save`` to ``path`` through a rename, so that a reader
    polling for it never sees it half written."""
    torch.save(obj, path + ".part")
    os.replace(path + ".part", path)


def whole_cpu_state(g, d) -> dict:
    """G's and D's whole state dicts (``g.``, ``d.`` keys) on the host."""
    from xgan_torch.parallel import tp
    return {**{f"g.{k}": v.cpu().clone()
               for k, v in tp.whole_state_dict(g).items()},
            **{f"d.{k}": v.cpu().clone()
               for k, v in tp.whole_state_dict(d).items()}}


def tp_timings(world, data, train, smi: str, rank: int, part: int) -> list:
    """The timings of A14 part ``part``'s tensor parallelism, alone on the
    card (two gloo ranks, ``--model-parallel 2``; ``world`` and its data
    group), rank 0 timing while rank 1 waits: the sliced ConvT layers of
    ``TP_CONVT`` at the trainers' batch (part 4's DCGAN G's at (128, 7, 7,
    512) -> 128, part 5's WGAN-GP G's at (64, 7, 7, 1024) -> 256 and (64,
    14, 14, 512) -> 128), each by :func:`sliced_convt_ms`; then part 5's
    bf16 CGAN steps (:func:`tp_family_timings`). Returns the TP steps'
    [ConvT, mixed_gather] launches."""
    if rank == 0:  # alone on the card: rank 1 waits
        for i, (kind, hw, cin, cout) in enumerate(TP_CONVT[part]):
            ms = sliced_convt_ms(TP_TRAIN_B[kind], hw, cin, cout, 64 + i)
            print(f"sliced ConvT at {ms['shape']}, bf16, alone on the "
                  f"card: kernel {ms['kernel']:.4f} ms, plain "
                  f"{ms['plain']:.4f} ms, cuDNN {ms['cuDNN']:.4f} ms "
                  f"(F.conv_transpose2d), bound {ms['bound']:.4f} ms "
                  f"({ms['work']}; by {ms['bound_by']}) [{smi}]")
    world.barrier()
    return tp_family_timings(world, data, train, smi, rank) \
        if part == 5 else [0, 0]


def sliced_convt_ms(b: int, hw: int, cin: int, cout: int,
                    seed: int) -> dict:
    """A sliced k4s2 ConvT launch at x (``b``, ``hw``, ``hw``, ``cin``)
    -> ``cout``, bf16, act none: the kernel, its plain
    version and cuDNN's ``F.conv_transpose2d`` on the same inputs by CUDA
    events, and the bound (each output sums 4 taps of Cin over the 4
    phases of 2 x 2; bf16 x, packed w and out each moved once)."""
    from xgan_torch.kernels.convt import (convt4x4s2_fused,
                                          convt4x4s2_fused_ref,
                                          pack_convt_weight)
    dev = torch.device("cuda")
    gk = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn(b, hw, hw, cin, generator=gk, device=dev) \
        .to(torch.bfloat16)
    w = torch.randn(cin, cout, 4, 4, generator=gk, device=dev) \
        / math.sqrt(4 * cin)
    wp = pack_convt_weight(w, torch.bfloat16)
    ones_o = torch.ones(cout, device=dev)
    zeros_o = torch.zeros(cout, device=dev)
    xn, wl = x.permute(0, 3, 1, 2), w.to(torch.bfloat16)  # NCHW views
    ms = {name: time_ms(lambda fn=fn: fn(x, wp, ones_o, zeros_o,
                                         act="none"), reps=reps)
          for name, fn, reps in (("kernel", convt4x4s2_fused, 20),
                                 ("plain", convt4x4s2_fused_ref, 5))}
    ms["cuDNN"] = time_ms(
        lambda: torch.nn.functional.conv_transpose2d(xn, wl, None, 2, 1))
    flops = 2 * b * (2 * hw) ** 2 * cout * cin * 4
    nbytes = 2 * (b * hw * hw * cin + 16 * cin * cout
                  + b * (2 * hw) ** 2 * cout)
    ms["bound"] = max(flops / BF16_PEAK_FLOPS, nbytes / HBM_BYTES_PER_S) * 1e3
    ms["bound_by"] = "operations" if flops / BF16_PEAK_FLOPS \
        >= nbytes / HBM_BYTES_PER_S else "bytes"
    ms["shape"] = f"x ({b}, {hw}, {hw}, {cin}) -> Cout {cout}"
    ms["work"] = f"{flops / 1e9:.2f} GFLOP, {nbytes / 1e6:.2f} MB"
    return ms


def tp_family_timings(world, data, train, smi: str, rank: int) -> list:
    """bf16 ms per CGAN-224 (B = 32) step of the two TP ranks
    (``--model-parallel 2`` over gloo, host-staged: not a scaling
    figure), then of one rank alone (rank 0, while rank 1 waits). The
    WGAN-GP's TP step is not timed: over gloo each of its gathers and
    their double backward is a host-staged all-reduce of an activation,
    seconds a step that measure the staging alone. Returns the TP steps'
    [ConvT, mixed_gather] launches (none: the CGAN's G runs no ConvT
    kernel)."""
    from xgan_torch import kernels
    stores = tp_stores(train, world.device)
    launched, times = [0, 0], {}
    for name, m in (("tp", data), ("one", None)):
        if m is None and rank == 1:
            world.barrier()
            continue
        for kind in ("cgan",):
            draw = tp_draws(kind, 1, TP_TRAIN_B[kind])[0]
            nets, _ = tp_nets(kind, m, dtype=torch.bfloat16)
            kernels.reset_launch_counts()
            # TP steps take a third of a second (host-staged gloo): fewer
            n, warm = (2, 1) if m is not None else (10, 3)
            times[f"{TP_LABEL[kind]} {name}"] = timed_steps(
                lambda: tp_step(kind, nets, stores, draw, mesh=m), n, m,
                warm)
            if m is not None:
                key, per_step = TP_LAUNCHES[kind]
                check(kernels.LAUNCHES[key] == per_step * (n + warm),
                      (kind, dict(kernels.LAUNCHES)))
                launched[0] += kernels.LAUNCHES["convt4x4s2_fused"]
            del nets
        if m is None:
            world.barrier()
    print(f"rank {rank}: bf16 ms per step (two ranks sharing the card over "
          f"host-staged gloo, not a scaling figure; one rank alone): "
          + ", ".join(f"{k} {v:.3f}" for k, v in times.items())
          + f" [{smi}]")
    return launched


def a14_4_argv(tmp: str, root: str, synth_dir: str, module: str,
               out: str) -> list:
    """The DCGAN CLI (224 px, B = 128, 2 epochs of 2 steps) or the
    classifier CLI (augmented, ResNet-50, B = 32, one run of 2 steps) as
    :func:`dp_cli_processes` runs them with no group, or the WGAN-GP or
    CGAN CLI as :func:`dp_loop_argv` runs them (f32), into ``out``."""
    if module == "train_gan":
        return gan_cli_argv(tmp, root, out, "--epochs", "2",
                            "--limit-batches", "2", "--compute-dtype", "f32")
    if module == "train_wggan":
        return family_cli_argv(tmp, root, out, WGAN_B, FG, "--critic-iters",
                               str(WGAN_CRITIC))
    if module == "train_cgan":
        return family_cli_argv(tmp, root, out, CGAN_B, CGAN_FM)
    return ["--data-dir", root, "--synthetic-dir", synth_dir,
            "--use-synthetic", "--k-folds", "1", "--epochs", "1",
            "--limit-batches", "2", "--model-dir", os.path.join(out, "m"),
            "--results-dir", os.path.join(out, "metrics"),
            "--figures-dir", os.path.join(out, "figures"),
            "--cache-dir", os.path.join(tmp, "cache"), "--workers", "8",
            "--image-size", str(SIZE), "--batch-size", str(CLS_B),
            "--compute-dtype", "f32"]


# the directories of the runs with no group (phase_dp_cli's and
# phase_dp_cli_loops', or phase 26's own when it runs alone)
A14_4_PLAIN = {"train_gan": ("dp", "gan_plain"),
               "train_classifier": ("dp", "clf_plain"),
               "train_wggan": ("dp2", "plain", "wgan"),
               "train_cgan": ("dp2", "plain", "cgan")}
# the trainers of each part of phase 26, and the GAN histories held
# (file, per-step keys)
A14_MODULES = {4: ("train_gan", "train_classifier"),
               5: ("train_wggan", "train_cgan")}
A14_HISTORIES = {"train_gan": ("gan_training_history.json", GAN_ITER_KEYS),
                 "train_wggan": ("wgan_training_history.json",
                                 ("D_losses", "G_losses")),
                 "train_cgan": ("cgan_training_history.json",
                                GAN_ITER_KEYS)}


def a14_4_processes(tmp: str, root: str, synth_dir: str,
                    plain: bool = False, parts=(4, 5)) -> dict:
    """The CLI processes of :func:`phase_a14_4`, all started at once (f32,
    TF32 off, deterministic cuDNN): the trainers of ``parts``
    (``A14_MODULES``; :func:`a14_4_argv`) as two gloo ranks on the card
    at ``--model-parallel 2`` (and, with ``plain``, with no group, as
    phase 24 runs them). Returns (run, rank) -> process."""
    procs = {}
    modules = [m for p in parts for m in A14_MODULES[p]]
    ports = iter(free_ports(len(modules)))
    for module in modules:
        if plain:
            procs[f"{module}_plain", 0] = dp_cli(module, a14_4_argv(
                tmp, root, synth_dir, module,
                os.path.join(tmp, *A14_4_PLAIN[module])), None)
        port = next(ports)
        for r in range(TP_N):
            procs[f"{module}_tp", r] = subprocess.Popen(
                [sys.executable, "-u", "-c", CLI_LAUNCHER, module,
                 *a14_4_argv(tmp, root, synth_dir, module,
                             os.path.join(tmp, "a14_4", f"{module}_tp")),
                 "--dist-backend", "gloo", "--model-parallel", str(TP_N)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                cwd=HERE, env=launch_env(r, TP_N, 0, port))
    return procs


def start_tp(tmp: str, smi: str, parts=(4, 5)) -> dict:
    """Starts phase 26's processes (:func:`start_fresh_ranks`): for each
    part, the two ranks of :func:`phase_tp` and the one-rank reference of
    :func:`phase_tp_ref` after them. Returns part -> (phase, processes,
    logs)."""
    held = {}
    for part in parts:
        phase, procs, logs = start_fresh_ranks(f"tp{part}", TP_N, tmp, smi)
        _, ref, ref_logs = start_fresh_ranks(f"tp{part}ref", 1, tmp, smi)
        held[part] = (phase, procs + ref, logs + ref_logs)
    return held


def phase_a14_4(tmp: str, root: str, synth_dir: str, smi: str,
                res: dict | None = None, held=None, parts=(4, 5)) -> list:
    """A14 parts 4 and 5 on the card (``parts``): tensor parallelism over
    two gloo ranks sharing it (``--model-parallel 2``). :func:`phase_tp`
    on both ranks (or ``held``, its ranks started earlier beside phase
    25's CLIs): the holds while the CLI runs of :func:`a14_4_processes`
    run (or ``res``, their (exit code, output), when they ran earlier,
    beside phase 24's CLIs), then, on ``tp_go``, the timings alone; both
    ranks' replicated leaves bitwise equal, their slices not. Under TP
    against no group (phase 24's runs, or its own alone): the same files,
    each TP rank's kernel launches those of the run with no group, the
    GAN histories' first step within 1e-4 * (1 + |ref|) and every step
    within 5e-2, the classifier's every JSON number but the flags within
    1e-4 * (1 + |ref|). Returns the (ConvT, mixed_gather) launches."""
    procs = a14_4_processes(tmp, root, synth_dir, plain=True, parts=parts) \
        if res is None else {}
    held = held or start_tp(tmp, smi, parts)
    launched = [0, 0]
    try:
        if res is None:
            res = drain_all(procs)
        for part in parts:  # each part's timings alone on the card
            wait_ready(tmp, f"tp{part}", held[part][1])
            go(tmp, f"tp{part}")
            for got in finish_fresh_ranks(held[part]):
                launched = [a + b for a, b in zip(launched, got)]
            ranks = [torch.load(os.path.join(tmp, f"tp{part}_rank{r}.pt"),
                                weights_only=True) for r in range(TP_N)]
            sliced = set(ranks[0]["sliced"])
            check(sliced == set(ranks[1]["sliced"]) and sliced, sliced)
            for k, v in ranks[0]["local"].items():
                same = torch.equal(v, ranks[1]["local"][k])
                check(same != (k in sliced), f"{k}: sliced {k in sliced}, "
                      f"equal on both ranks {same}")
        for key, (rc, text) in res.items():
            check(rc == 0, f"{key}: exit {rc}\n" + text[-3000:])
        modules = [m for p in parts for m in A14_MODULES[p]]
        for module in modules:
            for r in range(TP_N):
                text = res[f"{module}_tp", r][1]
                check(f"Tensor parallelism: mesh {{'data': 1, 'model': "
                      f"{TP_N}}}; rank {r} is data rank 0, model rank {r}"
                      in text, text[-2000:])

        def launches(key):
            last = res[key][1].strip().splitlines()[-1]
            check(last.startswith("LAUNCHES "), last)
            return json.loads(last[len("LAUNCHES "):])

        def tree(*name):
            top = os.path.join(tmp, *name)
            return top, sorted(os.path.relpath(os.path.join(p, f), top)
                               for p, _, fs in os.walk(top) for f in fs)

        worst = {}
        for module in modules:
            top0, files0 = tree(*A14_4_PLAIN[module])
            top, files = tree("a14_4", f"{module}_tp")
            check(files == files0 and files, (module, files, files0))
            if (f"{module}_plain", 0) in res:  # run here, not in phase 24
                PLAIN_LAUNCHES[module] = launches((f"{module}_plain", 0))
            for r in range(TP_N):
                got = launches((f"{module}_tp", r))
                check(all(got.get(k, 0) == n for k, n in
                          PLAIN_LAUNCHES[module].items()), (module, r, got))
                for k, n in got.items():
                    if k in ("convt4x4s2_fused", "mixed_gather"):
                        launched[k == "mixed_gather"] += n
            if module == "train_classifier":
                w = 0.0
                for f in files0:
                    if f.endswith(".json"):
                        with open(os.path.join(top0, f)) as fh:
                            want = json.load(fh)
                        with open(os.path.join(top, f)) as fh:
                            got_j = json.load(fh)
                        # the flags the run was given differ by design
                        for j in (want, got_j):
                            j.pop("config", None)
                        w = max(w, f32_close(json_numbers(got_j),
                                             json_numbers(want)))
                check(w <= 1e-4, (module, w))
                worst[module] = [w]
                continue
            name, keys = A14_HISTORIES[module]
            h = []
            for t in (top0, top):
                with open(os.path.join(t, "metrics", name)) as fh:
                    h.append(json.load(fh))
            per_step = history_steps_close(h[1], h[0], keys)
            check(per_step[0] <= 1e-4 and max(per_step) <= 5e-2,
                  (module, per_step))
            worst[module] = per_step
    finally:
        for proc in [*procs.values(),
                     *(p for h in held.values() for p in h[1])]:
            if proc.poll() is None:
                proc.kill()
    print(f"A14 parts {', '.join(map(str, parts))} CLIs at --model-parallel "
          f"{TP_N} (two gloo ranks on the card, f32, TF32 off, deterministic "
          "cuDNN) against no group: the same files and launches on each "
          "rank; worst |a-b|/(1+|b|) per step: "
          + "; ".join(f"{k} " + ", ".join(f"{v:.3g}" for v in vs)
                      for k, vs in worst.items())
          + " (limits: a GAN's step 1 1e-4, all 5e-2; the classifier's "
          f"every number 1e-4); phase 26's launches: ConvT {launched[0]}, "
          f"mixed_gather {launched[1]} [{smi}]")
    return launched


def history_steps_close(got: dict, want: dict, keys) -> list:
    """Per step, worst |got - want| / (1 + |want|) over a GAN history's
    per-step ``keys`` (a key with several entries a step, such as the
    critic's losses, counts each in its step)."""
    steps = len(want[keys[-1]])
    return [f32_close([got[k][t] for k in keys for t in range(len(want[k]))
                       if t * steps // len(want[k]) == s],
                      [want[k][t] for k in keys for t in range(len(want[k]))
                       if t * steps // len(want[k]) == s])
            for s in range(steps)]


def json_numbers(v) -> list:
    """The numbers of a JSON value, in order."""
    if isinstance(v, dict):
        return [x for k in sorted(v) for x in json_numbers(v[k])]
    if isinstance(v, list):
        return [x for e in v for x in json_numbers(e)]
    return [float(v)] if isinstance(v, (int, float)) else []


# the phases that hold a kernel count read from a profiler window,
# called with (the train store, the card's line, the run)
FRESH_PHASES = {
    "gan_profile": lambda train, smi, run: phase_gan_profile(train),
    "loop_steps_per_call": phase_loop_steps_per_call,
    "loop_wgan": phase_loop_wgan,
    "profile": lambda train, smi, run: phase_profile(),
    "artifact_profile": phase_artifact_profile,
    "dist": phase_dist,
    "dist1": phase_dist1,
    **{f"kstep_{kind}": lambda train, smi, run, kind=kind: phase_kstep_dp(
        train, smi, kind) for kind in ("dcgan", "wgan")},
    "zero": phase_zero,
    **{f"tp{part}{ref}": lambda train, smi, rank, part=part, ref=ref: (
        phase_tp_ref if ref else phase_tp)(train, smi, rank, part)
       for part in (4, 5) for ref in ("", "ref")},
}
CHILD_TMP = None  # a --phase process's temporary directory


def fresh_runs(phase: str, runs, fields: str, tmp: str, smi: str) -> int:
    """Each run of ``phase`` in a process of its own; prints each run's
    ms per step over run 0's (``runs`` hold ``fields``) and returns their
    launches."""
    out = [in_fresh_process(f"{phase}/{i}", tmp, smi)
           for i in range(len(runs))]
    print(f"{phase}: ms per step, over {fields} = {runs[0]}'s: "
          + "; ".join(f"{fields} = {r}: {ms / out[0][1]:.3f}"
                      for r, (_, ms) in zip(runs[1:], out[1:])))
    return sum(launched for launched, _ in out)


def main_a14_3():
    """``python3 chip_smoke.py --only a14_3``: the build, the sampler (the
    synthetic set), the RSNA tree and its stores, then
    :func:`phase_a14_3` alone (a quick check of this slice's paths; it
    prints no result line)."""
    smi = phase_card()
    phase_build()
    with tempfile.TemporaryDirectory(prefix="xgan_chip_smoke_") as tmp:
        phase_sampler(tmp)
        root, synth_dir = os.path.join(tmp, "rsna"), \
            os.path.join(tmp, "synthetic")
        write_rsna_tree(root)
        train, _ = phase_stores(root, synth_dir)
        save_store(train, tmp)
        print(f"launches (ConvT, mixed_gather): "
              f"{phase_a14_3(tmp, root, synth_dir, smi)}")


def main_a14(part: int):
    """``python3 chip_smoke.py --only a14_4`` (or ``a14_5``): the build, the
    sampler, the RSNA tree and its stores, then :func:`phase_a14_4` of
    that part alone (a quick check of a slice's paths; it prints no
    result line)."""
    smi = phase_card()
    phase_build()
    with tempfile.TemporaryDirectory(prefix="xgan_chip_smoke_") as tmp:
        phase_sampler(tmp)
        root, synth_dir = os.path.join(tmp, "rsna"), \
            os.path.join(tmp, "synthetic")
        write_rsna_tree(root)
        train, _ = phase_stores(root, synth_dir)
        save_store(train, tmp)
        print(f"launches (ConvT, mixed_gather): "
              f"{phase_a14_4(tmp, root, synth_dir, smi, parts=(part,))}")


def main():
    smi = phase_card()
    phase_build()
    warm_interpreters()
    entry = phase_kernels()
    phase_wgan_kernels(smi)
    gather_entry = phase_gather()
    with tempfile.TemporaryDirectory(prefix="xgan_chip_smoke_") as tmp:
        launches, warm_rate = phase_sampler(tmp)
        root, synth_dir = os.path.join(tmp, "rsna"), \
            os.path.join(tmp, "synthetic")
        write_rsna_tree(root)
        train, synth = phase_stores(root, synth_dir)
        save_store(train, tmp)
        phase_png(tmp, smi)
        gather_entry["launches"] = phase_classifier(tmp, root, synth_dir)
        gan_launches = phase_gan(tmp, root)
        phase_analyzer(tmp, root, synth_dir, smi)
        wgan_launches = phase_wgan_sampler(tmp) + phase_wgan_train(tmp, root)
        phase_cgan_train(tmp, root)
        loop_launches = phase_loop_cli(tmp, root, train, smi)
        gather_entry["launches"] += phase_loop_classifier(
            tmp, root, synth_dir, train, synth, smi)
        phase_f32_step(train, synth)
        phase_classifier_profile(train, synth)
        phase_gan_step_check(train)
        in_fresh_process("gan_profile", tmp, smi)
        phase_wgan_step_check(train)
        phase_wgan_profile(train, smi)
        phase_cgan_step_check(train)
        phase_cgan_profile(train, smi)
        loop_launches += phase_loop_grad_accum(train, smi)
        loop_launches += fresh_runs("loop_steps_per_call",
                                    STEPS_PER_CALL_RUNS,
                                    "(K, capturable Adam)", tmp, smi)
        loop_launches += fresh_runs("loop_wgan", WGAN_LOOP_RUNS, "(K, A)",
                                    tmp, smi)
        phase_loop_cgan(train, smi)
        busy_ms = in_fresh_process("profile", tmp, smi)
        gather_entry["launches"] += phase_parallel_folds(
            tmp, root, synth_dir, train, synth, smi)
        gather_entry["launches"] += phase_parallel_times(train, synth, smi)
        paths, inf_launches = phase_msgpack(tmp, root)
        arts, verified = phase_export(tmp, paths)
        inf_launches += verified + in_fresh_process("artifact_profile", tmp,
                                                    smi)
        phase_predict(tmp, root, paths, arts)
        phase_serve(tmp, root, arts, smi)
        gather_entry["launches"] += phase_data_loader(tmp, root, synth_dir)
        # phase 26's part 4 CLIs run beside phase 24's, its held steps and
        # part 5 CLIs beside phase 25's CLIs: each before the timed phases
        # there
        a14_4_res = a14_4_processes(tmp, root, synth_dir, parts=(4,))
        dp_convt, dp_gather = phase_dp(tmp, root, synth_dir, smi, a14_4_res)
        gather_entry["launches"] += dp_gather
        held = start_tp(tmp, smi)
        part5 = a14_4_processes(tmp, root, synth_dir, parts=(5,))
        try:
            a14_convt, a14_gather = phase_a14_3(tmp, root, synth_dir, smi,
                                                held, part5)
        except BaseException:
            for _, procs, _ in held.values():  # they wait for their go
                for proc in procs:
                    proc.kill()
            raise
        a14_4_res.update(part5)
        dp_convt += a14_convt
        gather_entry["launches"] += a14_gather
        a14_convt, a14_gather = phase_a14_4(tmp, root, synth_dir, smi,
                                            a14_4_res, held)
        dp_convt += a14_convt
        gather_entry["launches"] += a14_gather
    loop_ms_per_batch = B / warm_rate * 1e3
    print(f"sampler loop: {loop_ms_per_batch:.2f} ms per batch of {B} "
          f"(warm median) vs {busy_ms:.3f} ms profiled device time per "
          f"batch: device idle share ~{1 - busy_ms / loop_ms_per_batch:.3f}")
    entry["launches"] = (launches["convt4x4s2_fused"] + gan_launches
                         + wgan_launches + loop_launches + inf_launches
                         + dp_convt)
    print(json.dumps({"kernels": [entry, gather_entry]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


for _name in [n for n in globals() if n.startswith("phase_")] + [
        "cli_process", "dp_cli", "in_fresh_process", "in_fresh_ranks",
        "finish_fresh_ranks", "tp_holds", "tp_timings"]:
    globals()[_name] = timed(globals()[_name])

if __name__ == "__main__":
    if sys.argv[1:2] == ["--wait"]:
        sys.argv[1:] = wait_command() or sys.exit(0)
    if sys.argv[1:2] == ["--phase"]:
        phase_child(*sys.argv[2:5])
    elif sys.argv[1:3] == ["--only", "a14_3"]:
        main_a14_3()
    elif sys.argv[1:3] in (["--only", "a14_4"], ["--only", "a14_5"]):
        main_a14(int(sys.argv[2][-1]))
    else:
        main()
