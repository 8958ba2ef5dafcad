"""Time the data-parallel DCGAN-224 and WGAN-GP-224 steps of the
xgan_torch tree at ``--root`` (default: this checkout) on one card,
through a world-1 NCCL group and with no group.

    python3 tools_torch/time_dp_steps.py [--root DIR] [--label NAME]

The process joins a world-1 NCCL group itself (a free localhost port),
builds the seeded full-width nets (64 feature maps, 224 px) in bf16
with the trainers' capturable Adam, a seeded uint8 store of 512 images
on the card, and times bf16 steps: the DCGAN at B = 128 and the WGAN-GP
at B = 64 with 5 critic updates, each tied to the group (every
all-reduce and the cross-rank BN of the DP path) and to none, one step
a call (K = 1) and 4 steps a call (K = 4: one CUDA graph a call, the
trainers' ``--steps-per-call 4``, which takes the host's cost per call
out), in turns (none, group, group, none), in ms per step by the host
clock around synchronised calls after warm ones. It prints the card's
name and power limit, then one JSON line ``{"label", "root", "ms":
{"dcgan none K=1": [...], ...}}``. To compare two trees, run it once
for each, in turns (A, B, B, A), one after another on one card.
"""
import argparse
import collections
import json
import os
import socket
import subprocess
import sys
import time

LATENT, FM, SIZE, N = 100, 64, 224, 512
DCGAN_B, WGAN_B, CRITIC, K = 128, 64, 5, 4
STEPS = {"dcgan": 12, "wgan": 4}  # timed steps a turn, for K = 1 and K


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _timed(call, calls: int, steps_per_call: int) -> float:
    """ms per step of ``calls`` calls after 2 warm ones."""
    import torch
    for _ in range(2):
        call()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        call()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / (calls * steps_per_call) * 1e3


def main() -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--root", default=os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    p.add_argument("--label", default="")
    args = p.parse_args()
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import torch
    if not torch.cuda.is_available():
        print("Error: no CUDA device is available")
        sys.exit(1)
    from xgan_torch.models import dcgan, wgan
    from xgan_torch.models.layers import sync_batch_norm
    from xgan_torch.parallel.mesh import init_from_env, shutdown
    from xgan_torch.train.common import adam
    from xgan_torch.train.gan import dcgan_step
    from xgan_torch.train.multistep import StepsPerCall
    from xgan_torch.train.wgan import wgan_step
    os.environ.update(RANK="0", WORLD_SIZE="1", LOCAL_RANK="0",
                      MASTER_ADDR="127.0.0.1", MASTER_PORT=str(_free_port()))
    mesh = init_from_env(cpu=False)
    dev, bf16 = mesh.device, torch.bfloat16
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    images = torch.randint(0, 256, (N, SIZE, SIZE, 3), dtype=torch.uint8,
                           device=dev,
                           generator=torch.Generator(dev).manual_seed(0))
    calls = {}
    try:
        for name, m in (("none", None), ("group", mesh)):
            for k in (1, K):
                gens = [torch.Generator(dev).manual_seed(s) for s in (1, 6)]
                nets = []
                for mod, disc, seed in ((dcgan, dcgan.Discriminator, 2),
                                        (wgan, wgan.Critic, 4)):
                    g = mod.Generator(LATENT, 3, FM, SIZE, dtype=bf16,
                                      device=dev, generator=torch.Generator(
                                          dev).manual_seed(seed))
                    d = disc(3, FM, SIZE, dtype=bf16, device=dev,
                             generator=torch.Generator(dev)
                             .manual_seed(seed + 1))
                    sync_batch_norm(g, m)
                    sync_batch_norm(d, m)
                    beta2 = 0.999 if mod is dcgan else 0.9
                    nets.append((g, d, adam(g.parameters(), 2e-4, 0.5, beta2,
                                            capturable=True),
                                 adam(d.parameters(), 2e-4, 0.5, beta2,
                                      capturable=True)))

                def dstep(i, n=nets[0], m=m, gen=gens[0]):
                    return dcgan_step(*n, images, i, latent_dim=LATENT,
                                      dtype=bf16, generator=gen, mesh=m)

                def wstep(i, n=nets[1], m=m, gen=gens[1]):
                    return wgan_step(*n, images, i, latent_dim=LATENT,
                                     critic_iters=CRITIC, lambda_gp=10.0,
                                     dtype=bf16, generator=gen, mesh=m)

                for kind, step, b, gen in (
                        ("dcgan", dstep, DCGAN_B, gens[0]),
                        ("wgan", wstep, WGAN_B, gens[1])):
                    idx = torch.randint(0, N, (k, b), device=dev,
                                        generator=gen)
                    if k == 1:
                        calls[kind, name, k] = lambda s=step, i=idx: s(i[0])
                    else:
                        multi = StepsPerCall(step, k, gen)
                        calls[kind, name, k] = lambda f=multi, i=idx: f(i)
        ms = collections.defaultdict(list)
        for name in ("none", "group", "group", "none"):
            for kind in ("dcgan", "wgan"):
                for k in (1, K):
                    key = f"{kind} {name} K={k}"
                    try:
                        ms[key].append(_timed(calls[kind, name, k],
                                              STEPS[kind] // k, k))
                    except RuntimeError as e:  # a tree that cannot
                        ms[key].append(f"failed: {e}"[:200])
    finally:
        shutdown(mesh)
    print(card)
    print(json.dumps({"label": args.label, "root": root, "ms": ms}))


if __name__ == "__main__":
    main()
