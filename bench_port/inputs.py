"""Everything a run feeds the program, made from ``--seed`` on the device.

- the image store: ``(rows, S, S, 3)`` uint8, one ``torch.randint`` call
  (26,684 rows at 224 px are the RSNA stage-2 train count, 4.0 GB, the
  size the port's ``DeviceStore`` holds);
- the epoch order: one ``torch.randperm`` of the rows, cut into full
  batches (every row of a batch differs, and the first batches, which the
  check compares, share no row);
- the initial weights of each net in the published repository's layout:
  one ``torch.randn`` per net, cut into the leaves that the reference
  lists (its ``leaves(cfg)``), as the reference's ``weights_init`` draws
  them: N(0, 0.02) convolution weights, N(1, 0.02) BN scales, zero BN
  biases;
- the seed of the step-draw generator (flip, noise, α).

Each is drawn from its own generator, seeded from ``--seed`` and a tag,
so the same seed gives the same inputs whatever else a run does.
"""
from __future__ import annotations

import dataclasses
import hashlib

import torch


def sub_seed(seed: int, tag: str) -> int:
    """A 63-bit seed for ``tag`` from the run's ``seed`` (any integer)."""
    digest = hashlib.sha256(f"{seed}:{tag}".encode()).digest()
    return int.from_bytes(digest[:8], "little") >> 1


def generator(seed: int, tag: str, device) -> torch.Generator:
    return torch.Generator(device).manual_seed(sub_seed(seed, tag))


@dataclasses.dataclass
class Inputs:
    store: torch.Tensor    # (rows, S, S, 3) uint8
    order: torch.Tensor    # (batches, B) int64
    draw_seed: int         # the step-draw generator's seed
    seed: int


def make(cfg: dict, cell: dict, seed: int, device) -> Inputs:
    """The store, the epoch order and the draw seed of one run."""
    s = cfg["image_size"]
    rows, b = cell["store_rows"], cell["batch"]
    store = torch.randint(0, 256, (rows, s, s, cfg["num_channels"]),
                          dtype=torch.uint8, device=device,
                          generator=generator(seed, "store", device))
    k = cell["steps_per_call"]
    n_batches = rows // b // k * k
    if n_batches < 2 * k:
        raise ValueError(f"{rows} store rows hold fewer than two calls of "
                         f"{k} batches of {b}")
    perm = torch.randperm(rows, device=device,
                          generator=generator(seed, "order", device))
    order = perm[:n_batches * b].reshape(n_batches, b)
    return Inputs(store, order, sub_seed(seed, "draws"), seed)


def weights(leaves: dict, seed: int, device) -> dict:
    """``{net: {name: f32 tensor}}`` from ``leaves`` ``{net: [(name,
    shape, kind)]}``, kind one of ``conv`` (N(0, 0.02)), ``bn_weight``
    (N(1, 0.02)) and ``bn_bias`` (zero): one draw per net."""
    out = {}
    for net, items in leaves.items():
        drawn = [(n, shape, kind) for n, shape, kind in items
                 if kind != "bn_bias"]
        total = sum(_numel(shape) for _, shape, _ in drawn)
        z = torch.randn(total, device=device,
                        generator=generator(seed, f"weights.{net}", device))
        tensors, at = {}, 0
        for name, shape, kind in items:
            if kind == "bn_bias":
                tensors[name] = torch.zeros(shape, device=device)
                continue
            n = _numel(shape)
            t = z[at:at + n].reshape(shape) * 0.02
            at += n
            if kind == "bn_weight":
                t = t + 1.0
            elif kind != "conv":
                raise ValueError(f"unknown leaf kind {kind!r}")
            tensors[name] = t.contiguous()
        out[net] = tensors
    return out


def _numel(shape) -> int:
    n = 1
    for d in shape:
        n *= d
    return n


def call_rows(order: torch.Tensor, j: int, k: int) -> torch.Tensor:
    """The batch indices of call ``j``: ``(B,)`` at ``k`` = 1, ``(k, B)``
    above, cycling through the epoch order."""
    n = order.shape[0]
    i = (j * k) % n
    return order[i] if k == 1 else order[i:i + k]
