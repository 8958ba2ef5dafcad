"""Data-parallel ranks over a ``torch.distributed`` process group (role of
xgan/parallel/mesh.py).

The JAX package builds a ``("data", "model")`` mesh over every local
device and lets GSPMD insert the collectives: batches are row-sharded over
``data``, parameters, optimizer state and BN running statistics are
replicated, and every train-mode BN statistic and every loss mean is a
global reduction, so N-way data parallelism computes the function one
device computes, up to reduction order. The port launches one process a
rank, as PyTorch users do (``torchrun --nproc-per-node N -m
xgan_torch.cli.train_gan ...``), and writes those collectives by hand:

- :class:`MeshContext`: the rank, the world (the data axis), the device,
  ``pad_batch`` and each rank's ``local_rows``;
- :func:`all_reduce_sum`: a SUM all-reduce whose backward is one too, so
  a statistic summed across ranks (BN's sums, a loss's denominator) passes
  its gradient back to every rank's rows;
- :func:`all_reduce_grads`: the gradients of one update summed in one
  flattened buffer, so that every rank's Adam sees the same numbers and
  the parameters stay bitwise equal across ranks.

The collectives are ``all_reduce`` and ``broadcast``: gloo's CUDA path
offers those two and no other, and gloo runs two ranks on one card,
where NCCL refuses to. (ZeRO-1's parameter all-gather,
:mod:`xgan_torch.parallel.tp`, uses NCCL's ``all_gather_into_tensor`` and
a zero-padded all-reduce on gloo.)

:meth:`MeshContext.split` cuts the ranks into groups (``--parallel-folds``'
fold groups): each group is a context of its own whose rank, world and
collectives are the group's. :meth:`MeshContext.split_model` lays the
ranks out as the JAX package's ``(data, model)`` mesh for
``--model-parallel N`` (rank r at data index ``r // N``, model index ``r %
N``) and returns two groups: the data group (the ranks of one model
index), which every collective of data parallelism takes, and the model
group (the ranks of one data index), which tensor parallelism's take
(:mod:`xgan_torch.parallel.tp`). The data group's context carries the
model group (``model``), so that its file-writing rank, its stop decision
and its barrier stay those of every rank.
"""
from __future__ import annotations

import contextlib
import dataclasses
import os

import torch
import torch.distributed as dist

from xgan_torch.utils.timer import span

LAUNCH_ENV = ("RANK", "WORLD_SIZE", "LOCAL_RANK")


@dataclasses.dataclass(frozen=True)
class MeshContext:
    """One rank of a data-parallel run. ``distributed``: a process group
    was joined, so the steps take their collective path (also at world
    1, where each all-reduce returns its input)."""
    device: torch.device
    rank: int = 0
    world: int = 1
    distributed: bool = False
    # the process group of the collectives (None: every rank's) and the
    # global ranks it holds, in group-rank order
    group: object = None
    members: tuple = ()
    # the model group of this data group's rank (``split_model``), or None
    model: "MeshContext | None" = None

    @property
    def n_data(self) -> int:
        return self.world

    @property
    def is_main(self) -> bool:
        """Rank 0 (of the model group too): the one rank that writes
        files."""
        return self.rank == 0 and (self.model is None
                                   or self.model.rank == 0)

    def pad_batch(self, n: int) -> int:
        """Smallest multiple of the world size >= n (the global batch)."""
        return -(-n // self.world) * self.world

    def local_rows(self, b: int, accum: int = 1):
        """This rank's rows of a global batch of ``b`` (a multiple of the
        world size): the contiguous block ``[r*b/N, (r+1)*b/N)``.

        ``accum > 1`` (``--grad-accum``): the batch is ``accum``
        microbatches of ``mb = b/accum`` rows, each split over the ranks,
        as the JAX package row-shards every microbatch over ``data``:
        rank r holds rows ``[k*mb + lo, k*mb + hi)`` of microbatch k, with
        ``lo = r*mb//N`` and ``hi = (r+1)*mb//N`` (``mb`` need not be a
        multiple of N; a rank may hold none). Returned as an int64 index
        on the device, in microbatch order, so that this rank's rows of
        microbatch k are the k-th of ``accum`` equal blocks of what it
        selects (:meth:`micro_rows` of them). BN statistics are per
        microbatch, so a rank's contiguous block of the whole batch would
        give other numbers."""
        if accum > 1:
            if b % accum:
                raise ValueError(f"grad_accum={accum} must divide batch "
                                 f"size {b}")
            mb = b // accum
            return (torch.arange(accum, device=self.device)[:, None] * mb
                    + torch.arange(*self._share(mb), device=self.device)
                    ).reshape(-1)
        if b % self.world:
            raise ValueError(f"batch {b} is not a multiple of the "
                             f"{self.world} data ranks")
        n = b // self.world
        return slice(self.rank * n, (self.rank + 1) * n)

    def _share(self, mb: int) -> tuple[int, int]:
        """``[lo, hi)``: this rank's rows of a microbatch of ``mb``."""
        return (self.rank * mb // self.world,
                (self.rank + 1) * mb // self.world)

    def micro_rows(self, mb: int) -> int:
        """This rank's rows of one microbatch of ``mb`` rows
        (:meth:`local_rows` with ``accum > 1``)."""
        lo, hi = self._share(mb)
        return hi - lo

    @property
    def backend(self) -> str:
        """The process group's backend (``nccl`` or ``gloo``), or ``""``
        without one."""
        return dist.get_backend(self.group) if self.distributed else ""

    def global_rank(self, rank: int) -> int:
        """The global rank of this context's rank ``rank``."""
        return self.members[rank] if self.members else rank

    def split(self, groups) -> "MeshContext":
        """Cut the ranks into ``groups`` (lists of global ranks, every
        rank in one) and return this rank's group as a context of its own:
        its rank and world within the group, its collectives over the
        group alone. Every rank creates every group, in the same order
        (``dist.new_group`` asks that of every rank)."""
        mine = None
        for ranks in groups:
            ranks = tuple(int(r) for r in ranks)
            group = dist.new_group(list(ranks)) if self.distributed \
                else None
            if self.rank in ranks:
                mine = MeshContext(self.device, ranks.index(self.rank),
                                   len(ranks), self.distributed, group,
                                   ranks)
        if mine is None:
            raise ValueError(f"rank {self.rank} is in none of {groups}")
        return mine

    def split_model(self, n: int):
        """The ``(data, model)`` layout of ``--model-parallel n`` over
        these ranks (``n`` divides the world): returns ``(data, model)``,
        this rank's data group ``{m, m + n, ...}`` (its model index ``m``)
        carrying its model group ``{d*n, ..., d*n + n - 1}`` (its data
        index ``d``). Every rank calls it, in the same order."""
        if self.world % n:
            raise ValueError(f"--model-parallel {n} does not divide the "
                             f"{self.world} ranks")
        model = self.split([range(d * n, (d + 1) * n)
                            for d in range(self.world // n)])
        data = self.split([range(m, self.world, n) for m in range(n)])
        return dataclasses.replace(data, model=model), model

    def all_reduce_(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` summed over the ranks in place (no autograd)."""
        if self.distributed:
            dist.all_reduce(t, group=self.group)
        return t

    def broadcast_(self, t: torch.Tensor, src: int) -> torch.Tensor:
        """``t`` of this context's rank ``src`` on every rank, in place."""
        if self.distributed:
            dist.broadcast(t, src=self.global_rank(src), group=self.group)
        return t

    def all_gather(self, mine: torch.Tensor) -> torch.Tensor:
        """``(world, *mine.shape)``: every rank's ``mine``, in rank order
        (no autograd). NCCL's ``all_gather_into_tensor``; on gloo a zero
        buffer holding ``mine`` at this rank's place, summed over the ranks
        (``x + 0`` is exact)."""
        n = self.world
        if not self.distributed:
            return mine[None]
        out = mine.new_zeros((n, *mine.shape))
        if self.backend == "nccl":
            dist.all_gather_into_tensor(out.view(-1),
                                        mine.contiguous().view(-1),
                                        group=self.group)
            return out
        out[self.rank] = mine
        return self.all_reduce_(out)

    def gather_rows(self, t: torch.Tensor, b: int,
                    rows=None) -> torch.Tensor:
        """This rank's rows ``t`` of a global batch of ``b``, assembled
        into the whole batch on every rank: a zero buffer holding ``t`` at
        ``rows`` (default :meth:`local_rows`), summed over the ranks (the
        all-gather that gloo's CUDA path lacks). ``t`` is a float
        tensor."""
        if not self.distributed:
            return t
        out = t.new_zeros((b, *t.shape[1:]))
        out[self.local_rows(b) if rows is None else rows] = t
        return self.all_reduce_(out)

    def any(self, flag: bool) -> bool:
        """True on every rank when ``flag`` is true on any: the ranks'
        shared decision (and a barrier) at world > 1, over the model
        groups too (every rank of the run)."""
        model = self.model if self.model is not None \
            and self.model.world > 1 else None
        if self.world == 1 and model is None:
            return bool(flag)
        t = torch.tensor([float(bool(flag))], device=self.device)
        self.all_reduce_(t)
        if model is not None:
            model.all_reduce_(t)
        return bool(t.item() > 0)

    def barrier(self) -> None:
        """Wait for every rank (nothing at world 1)."""
        self.any(False)

    @contextlib.contextmanager
    def main_first(self):
        """Rank 0 runs the block first (it builds the store caches the
        others then read); the other ranks wait for it at a barrier."""
        if not self.is_main:
            self.barrier()
        try:
            yield
        finally:
            if self.is_main:
                self.barrier()


def launched() -> bool:
    """The process runs under a launcher's environment (``torchrun``)."""
    return all(k in os.environ for k in LAUNCH_ENV)


def init_from_env(cpu: bool, backend: str | None = None) -> MeshContext:
    """The run's context. Under a launcher's environment (``RANK``,
    ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``, ``MASTER_PORT``, as
    ``torchrun`` sets them) join the process group on ``cuda:LOCAL_RANK``
    with NCCL, or on the CPU with gloo under ``cpu``; ``backend``
    overrides that choice. Without it, the single-rank context on the
    CUDA device (the CPU with ``cpu``) and no process group.

    Raises RuntimeError when CUDA is missing without ``cpu``, or when
    ``LOCAL_RANK`` names a card this host lacks."""
    if not launched():
        from xgan_torch.config import resolve_device
        return MeshContext(resolve_device(cpu))
    rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    local = int(os.environ["LOCAL_RANK"])
    if cpu:
        device = torch.device("cpu")
    else:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is available; pass --cpu to "
                               "run on the CPU")
        if local >= torch.cuda.device_count():
            raise RuntimeError(
                f"LOCAL_RANK {local} names a card this host lacks "
                f"({torch.cuda.device_count()} visible)")
        device = torch.device("cuda", local)
        torch.cuda.set_device(device)
    dist.init_process_group(backend or ("gloo" if cpu else "nccl"),
                            init_method="env://", rank=rank,
                            world_size=world)
    return MeshContext(device, rank, world, True)


def shutdown(ctx: MeshContext) -> None:
    """Leave the process group ``ctx`` joined, if any."""
    if ctx.distributed and dist.is_initialized():
        dist.destroy_process_group()


class _AllReduceSum(torch.autograd.Function):
    """SUM over the ranks of ``group`` whose backward is this function
    again, so that autograd records it: a double backward (WGAN-GP's
    penalty through cross-rank BN) differentiates the backward's
    all-reduce as one more SUM all-reduce, issued by every rank in the
    same order. An in-place ``dist.all_reduce`` in the backward would be
    invisible to autograd, and the second derivative silently wrong."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        y = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        return _AllReduceSum.apply(g.contiguous(), ctx.group), None


def all_reduce_sum(x: torch.Tensor, mesh: MeshContext | None
                   ) -> torch.Tensor:
    """``x`` summed over the ranks, differentiably: the gradient of a
    loss summed over the ranks reaches each rank's ``x`` through one more
    SUM all-reduce. ``x`` itself without a process group."""
    if mesh is None or not mesh.distributed:
        return x
    return _AllReduceSum.apply(x, mesh.group)


@torch.no_grad()
def all_reduce_grads(params, mesh: MeshContext | None) -> None:
    """Sum the ``.grad`` of ``params`` over the ranks in one flattened
    buffer, in place (a parameter without a gradient is left out, as on
    every rank). Each rank's loss is its share of the global loss, so the
    sum is the global gradient, the same on every rank.

    Under tensor parallelism (``mesh.model``, a model group of several
    ranks) the gradients of the replicated parameters (those without a
    ``tp_dim``, :func:`xgan_torch.parallel.tp.shard_over_model`) are then
    broadcast from the model group's first rank: every rank of the group
    computed them, but two processes' cuDNN backward may add in other
    orders, and the narrow layers' copies must not drift apart."""
    if mesh is None or not mesh.distributed:
        return
    params = [p for p in params if p.grad is not None]
    if not params:
        return
    with span("dp_sync"):
        _flat_(params, lambda flat: dist.all_reduce(flat, group=mesh.group))
        model = mesh.model
        if model is not None and model.world > 1:
            replicated = [p for p in params
                          if getattr(p, "tp_dim", None) is None]
            if replicated:
                _flat_(replicated, lambda flat: model.broadcast_(flat, 0))


def _flat_(params, collective) -> None:
    """``collective`` on the gradients of ``params`` as one flattened
    buffer, copied back in place."""
    grads = [p.grad for p in params]
    flat = torch.cat([g.reshape(-1) for g in grads])
    collective(flat)
    offset = 0
    for g in grads:
        g.copy_(flat[offset:offset + g.numel()].view_as(g))
        offset += g.numel()
