"""Rehearse every cell of ``BENCHMARK.json`` on the CPU at a tiny size,
before any chip call:

    python3 bench_port/rehearse.py [--cells a,b]

Per cell: the inputs, the program as its ``programs/`` module builds it
(the port's plain paths on the CPU, float32; a data-parallel cell on a
one-rank gloo group), the compared first calls, two more calls, and the
check against the reference. It prints shapes and the numbers compared, never a time or a
device metric.
"""
import argparse
import os
import sys

sys.path[0] = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

import torch  # noqa: E402

from bench_port import catalog, harness  # noqa: E402


def rehearse(name: str, seed: int = 7) -> bool:
    cfg, cell = harness.load(name, tiny=True)
    s = harness.prepare(cfg, cell, seed, "cpu")
    outs = s.calls(2)
    inp, compared = s.inp, s.compared
    s.close()
    correct, shown = harness.judge(cfg, cell, inp, compared)
    print(f"{name}: store {tuple(inp.store.shape)}, order "
          f"{tuple(inp.order.shape)}, K {s.k}, compared steps "
          f"{len(compared.metrics)}, call output {tuple(outs[-1].shape)}, "
          f"correct {correct}, " + ", ".join(
              f"{k} {v['value']:.3g} (limit {v['limit']})"
              for k, v in shown.items()))
    return correct


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--cells", default="")
    args = p.parse_args(argv)
    torch.set_num_threads(min(4, torch.get_num_threads()))
    names = [w["name"] for w in catalog.benchmark()["workloads"]]
    if args.cells:
        names = args.cells.split(",")
    ok = all([rehearse(n) for n in names])
    bad = harness.forbidden_modules()
    print(f"forbidden modules loaded: {bad or 'none'}")
    return 0 if ok and not bad else 1


if __name__ == "__main__":
    sys.exit(main())
