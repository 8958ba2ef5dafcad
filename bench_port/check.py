"""The comparison that decides ``correct``.

The program's first steps (the window's own call, from the benchmark's
weights, on the first batches of the epoch order) against the plain
reference's. The numbers, each against its own limit from the cell's file
(a cell compares those its ``limits`` name):

- ``first_loss_gap``: the values that the first step computes before any
  optimizer update (the configuration's ``pre_update_values``: the
  DCGAN's loss_D, D(x) and D(G(z1)), the WGAN-GP's first critic loss), the
  largest ``|program - reference| / max(1, |reference|)``;
- ``loss_gap``: the same over every value of every compared step;
- ``grad_gap``: the first gradient of every leaf as the program's
  optimizer got it (its first moment after one update, over ``1 -
  beta1``) against the reference's, by its norm: the largest
  ``|‖g_p‖ - ‖g_r‖| / max(‖g_r‖, the net's median ‖g_r‖)``;
- ``grad_diff_gap``: the same first gradients by their difference, for
  the nets that the configuration's ``pre_update_nets`` names (those whose
  first gradient no earlier update has touched): the largest
  ``‖g_p - g_r‖ / max(‖g_r‖, the net's median ‖g_r‖)``. A norm moves only
  to second order under rounding that is not correlated with the
  gradient, so the norms of a float8 gradient and a bfloat16 one can read
  alike where their errors differ tenfold;
- ``change_gap``: each leaf's change over the compared steps, by its norm,
  measured the same way; a leaf whose reference first gradient is under a
  thousandth of its net's median moves under Adam by rounding alone and is
  left out.

A value that is not finite is reported as null and fails.
"""
from __future__ import annotations

import math
import statistics

NUMBERS = ("first_loss_gap", "loss_gap", "grad_gap", "grad_diff_gap",
           "change_gap")
MOVES_BY_ROUNDING = 1e-3


def loss_gap(prog: list, ref: list) -> float:
    if len(prog) != len(ref):
        raise ValueError(f"{len(prog)} program steps, {len(ref)} reference")
    worst = 0.0
    for p_row, r_row in zip(prog, ref):
        if len(p_row) != len(r_row):
            raise ValueError(f"step values differ: {p_row} vs {r_row}")
        for p, r in zip(p_row, r_row):
            gap = abs(p - r) / max(1.0, abs(r))
            worst = gap if not math.isfinite(gap) else max(worst, gap)
            if not math.isfinite(worst):
                return worst
    return worst


def leaf_gap(prog: dict, ref: dict, keep=None) -> tuple[float, str]:
    """The worst leaf's gap of norms (see the module docstring) over every
    net; ``keep``: {net: set of leaves}, the others left out."""
    worst, where = 0.0, ""
    for net, ref_norms in ref.items():
        names = [k for k in ref_norms if keep is None or k in keep[net]]
        if set(prog[net]) != set(ref_norms):
            raise ValueError(f"{net}: leaves differ")
        med = statistics.median(ref_norms[k] for k in names)
        for k in names:
            gap = abs(prog[net][k] - ref_norms[k]) / max(ref_norms[k], med)
            if not math.isfinite(gap):
                return gap, f"{net}.{k}"
            if gap > worst:
                worst, where = gap, f"{net}.{k}"
    return worst, where


def norms(first_grads: dict) -> dict:
    return {net: {k: float(v.double().norm()) for k, v in leaves.items()}
            for net, leaves in first_grads.items()}


def diff_gap(prog: dict, ref: dict) -> tuple[float, str, float]:
    """The worst leaf's ``‖p - r‖ / max(‖r‖, median ‖r‖)`` over the nets of
    ``ref``, where it is, and the median leaf's."""
    worst, where, all_gaps = 0.0, "", []
    for net, leaves in ref.items():
        med = statistics.median(float(r.double().norm())
                                for r in leaves.values())
        for k, r in leaves.items():
            gap = float((prog[net][k].double() - r.double()).norm()) \
                / max(float(r.double().norm()), med)
            all_gaps.append(gap)
            if not math.isfinite(gap):
                return gap, f"{net}.{k}", gap
            if gap > worst:
                worst, where = gap, f"{net}.{k}"
    return worst, where, statistics.median(all_gaps)


def moving_leaves(first_norms: dict) -> dict:
    """The leaves whose reference first gradient is at least a thousandth
    of their net's median leaf's."""
    out = {}
    for net, n in first_norms.items():
        med = statistics.median(n.values())
        out[net] = {k for k, v in n.items() if v >= MOVES_BY_ROUNDING * med}
    return out


def detail(prog, ref, cfg: dict) -> dict:
    """Where the gaps come from: each value's gap at the first step, each
    step's loss gap, each net's leaf gaps (for a look at the readings; the
    check takes :func:`readings`)."""
    p_norms, r_norms = norms(prog.first_grads), norms(ref.first_grads)
    keep = moving_leaves(r_norms)
    return {
        "first_step_gaps": [loss_gap([[p]], [[r]]) for p, r in
                            zip(prog.metrics[0], ref.metrics[0])],
        "loss_gap_by_step": [loss_gap([p], [r]) for p, r in
                             zip(prog.metrics, ref.metrics)],
        "grad_gap_by_net": {net: leaf_gap({net: p_norms[net]},
                                          {net: r_norms[net]})
                            for net in r_norms},
        "grad_diff_by_net": {net: diff_gap(
            {net: prog.first_grads[net]}, {net: ref.first_grads[net]})
            for net in ref.first_grads},
        "change_gap_by_net": {net: leaf_gap({net: prog.change[net]},
                                            {net: ref.change[net]},
                                            {net: keep[net]})
                              for net in ref.change}}


def readings(prog, ref, cfg: dict) -> dict:
    """Every number, each with the leaf that set it (or "")."""
    p_norms, r_norms = norms(prog.first_grads), norms(ref.first_grads)
    g, g_at = leaf_gap(p_norms, r_norms)
    nets = cfg["pre_update_nets"]
    d, d_at, _ = diff_gap({n: prog.first_grads[n] for n in nets},
                          {n: ref.first_grads[n] for n in nets})
    c, c_at = leaf_gap(prog.change, ref.change, moving_leaves(r_norms))
    pre = cfg["pre_update_values"]
    first = [[prog.metrics[0][i] for i in pre]]
    first_ref = [[ref.metrics[0][i] for i in pre]]
    return {"first_loss_gap": (loss_gap(first, first_ref), ""),
            "loss_gap": (loss_gap(prog.metrics, ref.metrics), ""),
            "grad_gap": (g, g_at), "grad_diff_gap": (d, d_at),
            "change_gap": (c, c_at)}


def judge(read: dict, limits: dict) -> tuple[bool, dict]:
    """``correct`` and, for the result line, each number that ``limits``
    names beside its limit (null where it is not finite)."""
    shown, ok = {}, True
    for name in NUMBERS:
        if name not in limits:
            continue
        value, at = read[name]
        limit = limits[name]
        fine = math.isfinite(value) and value <= limit
        ok = ok and fine
        shown[name] = {"value": value if math.isfinite(value) else None,
                       "limit": limit}
        if at:
            shown[name]["at"] = at
    if not shown:
        raise ValueError("the cell compares no number")
    return ok, shown
