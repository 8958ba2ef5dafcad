"""Which operators launch the device time of the WGAN-GP-224 train step.

    python3 tools_torch/profile_wgan_step.py [--root DIR] [--label NAME]
        [--steps N] [--out FILE]

Builds the xgan_torch tree at ``--root`` (default: this checkout) at the
published WGAN-GP defaults on the card: G and the critic at 64 feature
maps, 224 px, bf16 activations, B = 64, 5 critic updates, λ = 10, the
trainers' capturable Adam, a seeded uint8 store of 256 images on the card.
After 2 warm steps it times ``--steps`` steps by the host clock around a
synchronised run (ms a step), reads the tree's count of penalty-conv input
gradients a step (``xgan_torch.ops.conv.CALLS``, where the tree has it),
then profiles one step with host operators and their input shapes. Each
kernel is put to the chain of host operators open on its launching thread
when it was launched; the tool groups the step's kernel time by the
kernel's name, the innermost autograd node of that chain and the innermost
``aten::`` convolution operator with its input shapes.

Prints the card's name and power limit, the top groups (ms a step and
share of the step's kernel time), and one JSON line ``{"label", "root",
"ms_per_step", "conv_input_grads_per_step", "kernel_ms", "top"}``; with
``--out`` the whole table goes to that file as JSON. To compare two trees,
run it once for each in one call on one card.
"""
import argparse
import collections
import json
import os
import subprocess
import sys
import tempfile
import time

LATENT, FM, SIZE, B, CRITIC, LAMBDA, STORE = 100, 64, 224, 64, 5, 10.0, 256
CONV_OPS = ("aten::_convolution_double_backward", "aten::convolution_backward",
            "aten::cudnn_convolution", "aten::cudnn_convolution_transpose",
            "aten::convolution", "aten::conv_transpose2d")


def _card() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "unknown"


def _chains(events: list) -> dict:
    """{correlation id: [(name, input dims), ...] outermost first}: the host
    operators open on the launching thread at each kernel launch."""
    by_tid = collections.defaultdict(list)
    for e in events:
        if e.get("ph") != "X":
            continue
        cat = e.get("cat")
        if cat == "cpu_op":
            by_tid[e["tid"]].append((e["ts"], 0, e["ts"] + e["dur"],
                                     e["name"],
                                     e.get("args", {}).get("Input Dims")))
        elif cat == "cuda_runtime" and "correlation" in e.get("args", {}):
            by_tid[e["tid"]].append((e["ts"], 1, e["ts"],
                                     e["args"]["correlation"], None))
    out = {}
    for timeline in by_tid.values():
        timeline.sort(key=lambda t: (t[0], t[1], -t[2]))
        stack = []
        for start, kind, end, name, dims in timeline:
            while stack and stack[-1][0] < start:
                stack.pop()
            if kind == 0:
                stack.append((end, name, dims))
            else:
                out[name] = [(n, d) for _, n, d in stack]
    return out


def _group(chain: list) -> tuple:
    """(innermost autograd node, the outermost convolution operator and
    the innermost one with its input dims) of a launch's chain."""
    node, convs = "", []
    for name, dims in chain:
        if name.startswith("autograd::engine::evaluate_function: "):
            node = name.split(": ", 1)[1]
        if name in CONV_OPS:
            convs.append((name, dims))
    if not convs:
        return node, ""
    name, dims = convs[-1]
    inner = f"{name} {json.dumps(dims[:3]) if dims else ''}"
    return node, inner if len(convs) == 1 else f"{convs[0][0]} > {inner}"


def main() -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--root", default=os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    p.add_argument("--label", default="")
    p.add_argument("--steps", type=int, default=6)
    p.add_argument("--top", type=int, default=25)
    p.add_argument("--out", default="")
    a = p.parse_args()
    root = os.path.abspath(a.root)
    sys.path.insert(0, root)
    import torch
    from torch.profiler import ProfilerActivity, profile

    from xgan_torch.models.wgan import Critic, Generator
    from xgan_torch.train.common import adam
    from xgan_torch.train.wgan import wgan_step
    try:
        from xgan_torch.ops import conv as penalty_conv
    except ImportError:
        penalty_conv = None

    print(_card(), torch.__version__, flush=True)
    dev = torch.device("cuda")
    gen = torch.Generator(dev).manual_seed(0)
    g = Generator(LATENT, 3, FM, SIZE, dtype=torch.bfloat16, device=dev,
                  generator=gen)
    c = Critic(3, FM, SIZE, dtype=torch.bfloat16, device=dev, generator=gen)
    opt_g, opt_c = (adam(n.parameters(), 2e-4, 0.5, 0.9, capturable=True)
                    for n in (g, c))
    store = torch.randint(0, 256, (STORE, SIZE, SIZE, 3), dtype=torch.uint8,
                          device=dev, generator=gen)
    draws = torch.Generator(dev).manual_seed(1)

    def step(i):
        idx = (torch.arange(B, device=dev) + B * i) % STORE
        return wgan_step(g, c, opt_g, opt_c, store, idx, latent_dim=LATENT,
                         critic_iters=CRITIC, lambda_gp=LAMBDA,
                         dtype=torch.bfloat16, generator=draws)

    for i in range(2):
        step(i)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(a.steps):
        step(i)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) / a.steps * 1e3
    counts = None
    if penalty_conv is not None:
        penalty_conv.reset_call_counts()
        step(0)
        counts = dict(penalty_conv.CALLS)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=True) as prof:
        step(1)
        torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    chains = _chains(events)
    groups = collections.Counter()
    total = 0.0
    for e in events:
        if e.get("ph") != "X" or e.get("cat") != "kernel":
            continue
        dur = e["dur"] / 1e3
        total += dur
        node, conv = _group(chains.get(e.get("args", {}).get("correlation"),
                                       []))
        groups[(e["name"][:90], node, conv)] += dur
    rows = [{"kernel": k, "autograd_node": n, "conv_op": cv, "ms": v,
             "share": v / total} for (k, n, cv), v in groups.most_common()]
    print(f"{a.label}: {ms:.2f} ms a step (host clock, {a.steps} steps); "
          f"kernel time of the profiled step {total:.2f} ms; penalty-conv "
          f"input gradients a step {counts}")
    for r in rows[:a.top]:
        print(f"  {r['ms']:8.3f} ms {r['share']:.3f}  {r['kernel']}\n"
              f"      node {r['autograd_node'] or '-'}; {r['conv_op'] or '-'}")
    if a.out:
        os.makedirs(os.path.dirname(os.path.abspath(a.out)), exist_ok=True)
        with open(a.out, "w") as f:
            json.dump({"label": a.label, "card": _card(), "rows": rows}, f,
                      indent=1)
    print(json.dumps({"label": a.label, "root": root, "ms_per_step": ms,
                      "conv_input_grads_per_step": counts,
                      "kernel_ms": total, "top": rows[:a.top]}))


if __name__ == "__main__":
    main()
