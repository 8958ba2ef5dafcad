"""The readings that the check's limits are set from, at a cell's own size,
in one process on the card:

    python3 bench_port/calibrate.py --workload <cell> --seeds 1,2,... \\
        [--controls 3] [--out calibrate.jsonl]

For each seed, the program's numbers (its compared first calls against
the plain float32 reference, as a run's check takes them: the lower
readings). For the first ``--controls`` seeds also the control (the
reference with every product's operands in float8 e4m3, put in the
program's place) and each planted fault (:data:`FAULTS`) against the same
float32 reference: the upper readings. One JSON line per reading. The
benchmark's runs never run this.
"""
import argparse
import json
import os
import sys
import time

sys.path[0] = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

import torch  # noqa: E402

from bench_port import check, harness  # noqa: E402
from bench_port.reference.common import FAULTS  # noqa: E402


def emit(row: dict, out) -> None:
    line = json.dumps(row)
    print(line, flush=True)
    if out:
        out.write(line + "\n")
        out.flush()


def numbers(read: dict) -> dict:
    return {k: v[0] for k, v in read.items()} | {
        f"{k}_at": v[1] for k, v in read.items() if v[1]}


def calibrate(name: str, seeds: list, controls: int, out=None) -> list:
    cfg, cell = harness.load(name)
    rows = []
    for i, seed in enumerate(seeds):
        t = time.perf_counter()
        s = harness.prepare(cfg, cell, seed, "cuda")
        inp, compared = s.inp, s.compared
        s.close()
        ref = harness.reference_outputs(cfg, cell, inp)
        row = {"cell": name, "seed": seed, "kind": "program",
               **numbers(check.readings(compared, ref, cfg)),
               **check.detail(compared, ref, cfg),
               "seconds": time.perf_counter() - t}
        rows.append(row)
        emit(row, out)
        if i < controls:
            variants = [("fp8", dict(precision="fp8"))] + [
                (f, dict(fault=f)) for f in FAULTS]
            for kind, kw in variants:
                t = time.perf_counter()
                other = harness.reference_outputs(cfg, cell, inp, **kw)
                row = {"cell": name, "seed": seed, "kind": kind,
                       **numbers(check.readings(other, ref, cfg)),
                       **check.detail(other, ref, cfg),
                       "seconds": time.perf_counter() - t}
                rows.append(row)
                emit(row, out)
        del inp, ref
        torch.cuda.empty_cache()
    return rows


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--controls", type=int, default=3)
    p.add_argument("--out", default="")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    seeds = [int(x) for x in args.seeds.split(",")]
    out = None
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        out = open(args.out, "a")
    try:
        calibrate(args.workload, seeds, args.controls, out)
    finally:
        if out:
            out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
