"""The model-axis shape rule, ``--model-parallel`` on a world it does not
divide, and ZeRO-1 Adam moments over the ranks (role of
xgan/parallel/tp.py).

The JAX package shards a leaf over its mesh's ``model`` axis when the
leaf's rule dimension is at least ``min_features`` (256, ``MIN_FEATURES``)
and divisible by the axis size (:func:`model_axis_spec`): a conv kernel's
O in HWIO, a dense kernel's I in (I, O), a per-channel vector's only
dimension. The port holds torch layouts, so :func:`shard_dim` maps the
rule onto them by the module that owns the leaf:

- ``nn.Conv2d.weight`` (O, I, kh, kw): dimension 0;
- ``nn.ConvTranspose2d.weight`` (I, O, kh, kw): dimension 1;
- ``nn.Linear.weight`` (O, I): dimension 1, the dense rule's I;
- ``nn.Embedding.weight`` (N, D), as flax's ``Embed``: dimension 0;
- 1-D leaves (biases, BN's scale and shift): dimension 0.

``--shard-opt-state`` (:func:`shard_opt_state`, ZeRO-1) applies the rule
with the axis set to every rank: each rank keeps the Adam moments of its
slice of each wide parameter, and the narrow ones and every step count
whole. :class:`ShardedAdam` steps a ``torch.optim.Adam`` over those
slices (the same arithmetic and options, ``capturable`` on CUDA
included) in place in the parameters: a slice on a parameter's first
dimension is a view of it, and another slice (a transposed conv's or a
dense layer's) and its gradient are copied into dense tensors for the
step only, so that every tensor Adam sees is dense, as the replicated
run's are, and takes the same multi-tensor arithmetic. Then every
updated parameter is assembled on every rank, in buckets of at most
``BUCKET`` elements of slices: NCCL's ``all_gather_into_tensor``, or on
gloo an all-reduce of a zero buffer holding each rank's slices at its
own place (``x + 0`` is exact). Adam is element-wise, so the parameters
stay bitwise those of the replicated run. What the optimizer keeps
between steps is its state alone (:func:`state_bytes`). Its
``state_dict`` assembles the moments whole, in the layout
``torch.optim.Adam`` writes (a collective: every rank calls it), and
``load_state_dict`` takes such a whole state and keeps its slices.

``--model-parallel N`` with N > 1 dividing the ranks (tensor parallelism
across ranks) is not ported yet; :func:`model_parallel_from_args` prints
the JAX package's note and trains replicated for every N that does not
divide them.
"""
from __future__ import annotations

import torch
import torch.distributed as dist
from torch import nn

MIN_FEATURES = 256  # ResNet-50: shards stages conv3_x..conv5_x + fc
BUCKET = 1 << 22  # elements of slices a ZeRO-1 all-gather assembles


def model_axis_spec(shape, model_size: int,
                    min_features: int = MIN_FEATURES) -> int | None:
    """The dimension of a leaf of the JAX package's layout (HWIO conv
    kernels, (I, O) dense kernels, per-channel vectors) that the rule
    shards over an axis of ``model_size``, or None (replicated)."""
    def ok(dim):
        return dim >= min_features and dim % model_size == 0

    if len(shape) == 4 and ok(shape[3]):
        return 3
    if len(shape) in (1, 2) and ok(shape[0]):
        return 0
    return None


def _rule_dim(module: nn.Module, name: str, t: torch.Tensor) -> int | None:
    """The torch dimension that holds the JAX rule's dimension of
    ``module``'s leaf ``name`` (see the module docstring)."""
    if t.dim() == 1:
        return 0
    if name != "weight":
        return None
    if isinstance(module, nn.ConvTranspose2d) or (
            isinstance(module, nn.Linear) and t.dim() == 2):
        return 1
    if isinstance(module, (nn.Conv2d, nn.Embedding)):
        return 0
    return None


def shard_dim(module: nn.Module, name: str, t: torch.Tensor, n: int,
              min_features: int = MIN_FEATURES) -> int | None:
    """The dimension of ``module``'s leaf ``name`` (``t``) sharded over
    ``n`` ranks, or None (replicated)."""
    d = _rule_dim(module, name, t)
    if d is None or t.shape[d] < min_features or t.shape[d] % n:
        return None
    return d


def shard_dims(models, n: int, min_features: int = MIN_FEATURES) -> dict:
    """``{parameter: sharded dimension or None}`` of every parameter of
    ``models`` (modules) over ``n`` ranks."""
    out = {}
    for model in models:
        for module in model.modules():
            for name, p in module.named_parameters(recurse=False):
                out[p] = shard_dim(module, name, p, n, min_features)
    return out


def model_parallel_from_args(args, world: int) -> int:
    """``--model-parallel N`` against the ``world`` ranks of the run (1
    without a launch): 1 when N <= 1, or after the JAX package's note
    when N does not divide them (training replicated); N when it
    does."""
    n = getattr(args, "model_parallel", 1) or 1
    if n <= 1:
        return 1
    if world % n:
        print(f"Note: --model-parallel {n} does not divide the {world} "
              f"available device(s); training with replicated params.")
        return 1
    return n


class ShardedAdam:
    """ZeRO-1: ``opt`` (a ``torch.optim.Adam`` with no state yet) with the
    moments of each wide parameter kept for this rank's slice only (see
    the module docstring). ``dims``: ``{parameter: sharded dimension or
    None}``; ``mesh``: the joined ranks. ``zero_grad``, ``step``,
    ``state_dict`` and ``load_state_dict`` as the optimizer's, and
    ``param_groups`` and ``state``: those of the Adam over the slices."""

    def __init__(self, opt: torch.optim.Adam, dims: dict, mesh):
        self.mesh = mesh
        self.params = [p for g in opt.param_groups for p in g["params"]]
        self.wide = []  # (parameter, the Adam's tensor of its slice, dim)
        groups = []
        for group in opt.param_groups:
            slices = []
            for p in group["params"]:
                d = dims.get(p)
                if d is None:
                    slices.append(p)
                    continue
                # a tensor of its own, pointed at the slice (set_), that
                # keys the slice's state in the Adam
                s = torch.empty(0, dtype=p.dtype, device=p.device)
                s.set_(self._slice(p.detach(), d))
                self.wide.append((p, s, d))
                slices.append(s)
            groups.append({**group, "params": slices})
        self.inner = torch.optim.Adam(groups)
        self.nccl = mesh.backend == "nccl"

    @property
    def param_groups(self):
        return self.inner.param_groups

    @property
    def state(self):
        return self.inner.state

    def zero_grad(self, set_to_none: bool = True) -> None:
        for p in self.params:
            if set_to_none:
                p.grad = None
            elif p.grad is not None:
                p.grad.zero_()

    def _slice(self, t: torch.Tensor, d: int) -> torch.Tensor:
        k = t.shape[d] // self.mesh.world
        return t.narrow(d, self.mesh.rank * k, k)

    @torch.no_grad()
    def step(self, step=None) -> None:
        """One Adam step of this rank's slices (``step(inner)`` runs it
        instead of ``inner.step()``: the CGAN's gated step), then every
        updated parameter assembled on every rank. The slices are taken
        from the parameters at each step (a resume may have loaded them
        anew), views where dense, else dense copies for this step."""
        for p, s, d in self.wide:
            s.set_(self._slice(p.detach(), d).contiguous())
            s.grad = None if p.grad is None \
                else self._slice(p.grad, d).contiguous()
        if step is None:
            self.inner.step()
        else:
            step(self.inner)
        self._assemble()
        for p, s, d in self.wide:  # drop the step's copies
            s.grad = None
            s.set_(self._slice(p.detach(), d))

    def _all_gather(self, mine: torch.Tensor) -> torch.Tensor:
        """``(world, *mine.shape)``: every rank's ``mine``, in rank
        order."""
        mesh = self.mesh
        n = mesh.world
        out = mine.new_zeros((n, *mine.shape))
        if self.nccl:
            dist.all_gather_into_tensor(out.view(-1), mine.reshape(-1),
                                        group=mesh.group)
            return out
        out[mesh.rank] = mine  # gloo: a zero buffer summed over the ranks
        return mesh.all_reduce_(out)

    def _buckets(self):
        """The wide parameters in runs of at most ``BUCKET`` elements of
        slices (a larger slice alone)."""
        bucket, size = [], 0
        for item in self.wide:
            if bucket and size + item[1].numel() > BUCKET:
                yield bucket
                bucket, size = [], 0
            bucket.append(item)
            size += item[1].numel()
        if bucket:
            yield bucket

    def _assemble(self) -> None:
        n = self.mesh.world
        for bucket in self._buckets():
            every = self._all_gather(
                torch.cat([s.reshape(-1) for _, s, _ in bucket]))
            offset = 0
            for p, s, d in bucket:
                part = every[:, offset:offset + s.numel()]
                # every rank's slice at its place: p as (..., n, k, ...)
                p.detach().unflatten(d, (n, s.shape[d])).copy_(
                    part.reshape(n, *s.shape).movedim(0, d))
                offset += s.numel()

    @torch.no_grad()
    def state_dict(self) -> dict:
        """``torch.optim.Adam``'s state dict of the whole parameters (a
        collective of every rank: the wide moments are assembled)."""
        sd = self.inner.state_dict()
        index = {id(s): i for i, s in enumerate(
            p for g in self.inner.param_groups for p in g["params"])}
        state = dict(sd["state"])
        for p, s, d in self.wide:
            i = index[id(s)]
            if i not in state:
                continue
            st = dict(state[i])
            for key in ("exp_avg", "exp_avg_sq"):
                every = self._all_gather(st[key].contiguous())
                st[key] = torch.cat(list(every.unbind(0)), dim=d)
            state[i] = st
        return {"state": state, "param_groups": sd["param_groups"]}

    def shard_state_dict(self, sd: dict) -> dict:
        """A whole state dict (:meth:`state_dict`'s, or ``torch.optim.
        Adam``'s of the replicated run) cut to this rank's slices."""
        index = {id(s): i for i, s in enumerate(
            p for g in self.inner.param_groups for p in g["params"])}
        state = dict(sd["state"])
        for _, s, d in self.wide:
            i = index[id(s)]
            if i in state:
                st = dict(state[i])
                for key in ("exp_avg", "exp_avg_sq"):
                    st[key] = self._slice(st[key], d).clone()
                state[i] = st
        return {"state": state, "param_groups": sd["param_groups"]}

    def load_state_dict(self, sd: dict) -> None:
        self.inner.load_state_dict(self.shard_state_dict(sd))


def state_bytes(opt) -> int:
    """The bytes of every tensor of ``opt``'s state on this rank (the
    moments and the step counts): what an Adam or a :class:`ShardedAdam`
    keeps between steps."""
    return sum(v.nbytes for st in opt.state.values() for v in st.values()
               if torch.is_tensor(v))


def shard_opt_state(opt: torch.optim.Adam, models, mesh,
                    min_features: int | None = None):
    """``--shard-opt-state``: ``opt`` as a :class:`ShardedAdam` over the
    ranks of ``mesh`` for the parameters of ``models`` (the rule's width
    ``min_features``, ``MIN_FEATURES`` as it stands when called), or
    ``opt`` itself at world 1 (nothing to shard over, as the JAX package
    returns the state unchanged on one device)."""
    if mesh is None or not mesh.distributed or mesh.world == 1:
        return opt
    width = MIN_FEATURES if min_features is None else min_features
    sharded = ShardedAdam(opt, shard_dims(models, mesh.world, width), mesh)
    print(f"ZeRO-1: the Adam moments of {len(sharded.wide)} of "
          f"{len(sharded.params)} parameters split over {mesh.world} ranks")
    return sharded


def opt_from_args(args, opt: torch.optim.Adam, models, mesh):
    """``opt``, sharded by :func:`shard_opt_state` when the trainer's
    ``args`` ask for ``--shard-opt-state``."""
    if not getattr(args, "shard_opt_state", False):
        return opt
    return shard_opt_state(opt, models, mesh)
