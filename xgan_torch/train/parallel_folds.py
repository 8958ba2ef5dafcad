"""Parallel k-fold cross-validation: the k folds of a CV run train in
lockstep (role of xgan/train/parallel_folds.py, ``--parallel-folds``).

The JAX package stacks the fold states on a leading axis and vmaps its
train and eval steps over it; XLA lowers the vmap of a convolution to a
grouped convolution. :class:`FoldStack` holds the k folds' ResNet-50s as
one ``ResNet50(folds=k)``, that lowering written out
(``xgan_torch.models.resnet``): one channels_last ``(B, k*C, H, W)``
activation, fold-major in the channels, one cuDNN convolution with
``groups=k`` a layer, and one BN over the k * C channels, so that its
statistics reduce within a fold's rows only. On a batch whose rows are
all valid the BN is ``F.batch_norm`` (cuDNN), as the sequential path's
on a full batch; a batch with padded rows (an epoch's tail, a shorter
fold's repeats) takes the masked BN with each fold's own row weights.
``--remat`` checkpoints the grouped blocks or stages as it does one
model's. Ordinary autograd runs the backward. (``torch.func.vmap`` over
``functional_call`` of the port's ResNet was the first design: it ran,
but its batching rules copied every activation between layouts and its
masked BN's element-wise passes, so the lockstep step took 1.3-1.4x
five sequential steps on the card; ``PERF.md``.)

One :func:`lockstep_train_step` advances every fold by one batch: one
fold-batched ``mixed_gather`` launch builds the k batches from ``(k, B)``
indices over the shared stores, then the forward, each fold's loss and
:class:`FoldAdam`, whose step count is ``(k,)``: a fold that froze does
not advance it. A fold whose mask row is all zeros (a shorter fold past
its epoch's end) is frozen (``xgan/train/classifier.py:283-291``): its
parameters, BN running statistics, Adam moments and step count come out
bitwise as they went in. ``grad_accum`` composes under the fold axis as
in ``xgan/train/parallel_folds.py:96-110``: the same microbatches in
every fold, a fold's fully padded microbatch adding no gradient and
leaving its statistics alone.

:func:`fold_epoch_batches` and :func:`fold_masks` are numpy copies of the
JAX package's (``xgan/train/parallel_folds.py:205-240``).
"""
from __future__ import annotations

import numpy as np
import torch

from xgan_torch.data.pipeline import (epoch_batches, normalize_images,
                                      random_flip, take_rows)
from xgan_torch.models.resnet import ResNet50
from xgan_torch.parallel.mesh import all_reduce_grads
from xgan_torch.train.classifier import assemble, softmax_ce


def fold_epoch_batches(fold_indices, batch_size: int,
                       rng: np.random.Generator, shuffle: bool = True):
    """Per-fold index matrices aligned to a common batch count: (batches
    (num_batches, k, B) int32, n_valid (k,)). Shorter folds wrap around;
    ``n_valid`` is how many flattened entries of each fold are real."""
    per_fold = [epoch_batches(len(fi), batch_size, rng, shuffle=shuffle,
                              indices=fi) for fi in fold_indices]
    num_batches = max(pb.shape[0] for pb in per_fold)
    k = len(per_fold)
    out = np.zeros((num_batches, k, batch_size), np.int32)
    n_valid = np.zeros((k,), np.int64)
    for f, pb in enumerate(per_fold):
        reps = int(np.ceil(num_batches / pb.shape[0]))
        out[:, f, :] = np.concatenate([pb] * reps, axis=0)[:num_batches]
        n_valid[f] = min(len(fold_indices[f]), num_batches * batch_size)
    return out, n_valid


def fold_masks(num_batches: int, batch_size: int,
               n_valid: np.ndarray) -> np.ndarray:
    """(num_batches, k, B) float32 validity: position i*B + r of fold f is
    valid iff it is below the fold's epoch length (its wrap-padded tail
    and the lockstep batches a shorter fold repeats are 0)."""
    pos = (np.arange(batch_size)[None, None, :]
           + batch_size * np.arange(num_batches)[:, None, None])
    return (pos < np.asarray(n_valid)[None, :, None]).astype(np.float32)


def fold_view(t: torch.Tensor, k: int) -> torch.Tensor:
    """``t`` (k*n, ...), k folds' tensors concatenated on the first axis,
    as (k, n, ...): detached, sharing its memory."""
    return t.detach().unflatten(0, (k, -1))


class FoldStack:
    """k ResNet-50s of one configuration as one ``ResNet50(folds=k)``,
    ``model`` (see the module docstring); ``params`` and ``buffers``: its
    state-dict names to tensors, each the k models' concatenated on the
    first axis (:func:`fold_view` gives the fold axis).

    ``trainable``: the names whose tensor requires grad (``fc.*`` with a
    frozen base, every parameter with ``--unfreeze``); gradients land in
    their ``.grad``."""

    def __init__(self, models: list[ResNet50], trainable):
        ref = models[0]
        self.k = len(models)
        self.model = ResNet50(
            ref.num_classes, stage_sizes=ref.stage_sizes, dtype=ref.dtype,
            device="meta", remat=ref.remat, remat_scope=ref.remat_scope,
            folds=self.k)
        states = [m.state_dict() for m in models]
        # BN's num_batches_tracked (0-d) stays at 0: BN runs functionally
        self.model.load_state_dict(
            {n: torch.cat([sd[n] for sd in states]) if t.dim()
             else t.clone() for n, t in states[0].items()}, assign=True)
        trainable = set(trainable)
        for n, p in self.model.named_parameters():
            p.requires_grad_(n in trainable)
        self.params = dict(self.model.named_parameters())
        self.buffers = dict(self.model.named_buffers())
        self.trainable = [p for n, p in self.params.items() if n in trainable]

    def __call__(self, x: torch.Tensor, *, train: bool, mask=None):
        """The k folds' logits (k, B, classes) of ``x`` (k, B, H, W, 3);
        ``mask``: (k, B) BN row weights. A stack of one fold (a rank's
        share of a fold-sharded run) is one plain ResNet-50."""
        if self.k > 1:
            return self.model(x, train=train, mask=mask)
        return self.model(x[0], train=train,
                          mask=None if mask is None else mask[0])[None]

    def state_dict(self, fold: int) -> dict:
        """Fold ``fold``'s ResNet-50 state dict, copied to the host."""
        return {n: (fold_view(t, self.k)[fold] if t.dim() else t)
                .detach().cpu().clone()
                for n, t in self.model.state_dict().items()}

    def fold_tensors(self) -> list[torch.Tensor]:
        """Every parameter and BN statistic (what a frozen fold keeps)."""
        return [t for t in (*self.params.values(), *self.buffers.values())
                if t.dim()]


class FoldAdam:
    """Adam (lr, betas (0.9, 0.999), eps 1e-8; torch's arithmetic, its
    bias corrections in double on the host) over k folds' parameters,
    each the folds' tensors concatenated on the first axis, with a
    ``(k,)`` step count on the host: a fold advances its own count, and
    only when it is active."""

    def __init__(self, params: list[torch.Tensor], k: int, lr: float,
                 betas=(0.9, 0.999), eps: float = 1e-8):
        self.params, self.k = list(params), k
        self.lr, self.betas, self.eps = lr, betas, eps
        self.step_count = np.zeros(k, np.int64)
        self.exp_avg = [torch.zeros_like(p) for p in self.params]
        self.exp_avg_sq = [torch.zeros_like(p) for p in self.params]

    def zero_grad(self) -> None:
        for p in self.params:
            p.grad = None

    def state_tensors(self) -> list[torch.Tensor]:
        return [*self.exp_avg, *self.exp_avg_sq]

    @torch.no_grad()
    def step(self, active: np.ndarray) -> None:
        """One update of every fold; the caller puts back the state of
        the folds that ``active`` marks False (:func:`lockstep_train_step`),
        whose counts stay."""
        self.step_count += np.asarray(active, bool)
        b1, b2 = self.betas
        params = [fold_view(p, self.k) for p in self.params]
        grads = [fold_view(p.grad, self.k) for p in self.params]
        exp_avg = [fold_view(m, self.k) for m in self.exp_avg]
        exp_avg_sq = [fold_view(v, self.k) for v in self.exp_avg_sq]
        torch._foreach_lerp_(exp_avg, grads, 1 - b1)
        torch._foreach_mul_(exp_avg_sq, b2)
        torch._foreach_addcmul_(exp_avg_sq, grads, grads, 1 - b2)
        steps = np.maximum(self.step_count, 1).astype(np.float64)
        dev = self.params[0].device
        step_size = torch.tensor(-self.lr / (1 - b1 ** steps),
                                 dtype=torch.float32).to(dev)
        bc2_sqrt = torch.tensor(np.sqrt(1 - b2 ** steps),
                                dtype=torch.float32).to(dev)

        def per_fold(v, p):
            return v.view(-1, *([1] * (p.dim() - 1)))
        denom = torch._foreach_sqrt(exp_avg_sq)
        torch._foreach_div_(denom, [per_fold(bc2_sqrt, p) for p in params])
        torch._foreach_add_(denom, self.eps)
        update = torch._foreach_div(exp_avg, denom)
        torch._foreach_mul_(update, [per_fold(step_size, p) for p in params])
        torch._foreach_add_(params, update)


class _Keep:
    """Puts back, bitwise, the folds ``folds`` of ``tensors`` (of k
    folds, see :func:`fold_view`; of their ``.grad`` with ``grads``) on
    exit: what a frozen fold keeps."""

    def __init__(self, tensors, folds: np.ndarray, k: int,
                 grads: bool = False):
        self.folds = folds
        self.tensors = [t.grad if grads else t for t in tensors] \
            if folds.size else []
        self.tensors = [fold_view(t, k) for t in self.tensors
                        if t is not None]

    def __enter__(self):
        if self.tensors:
            self.idx = torch.from_numpy(self.folds).to(
                self.tensors[0].device)
            self.saved = [t.detach().index_select(0, self.idx)
                          for t in self.tensors]
        return self

    def __exit__(self, *exc):
        with torch.no_grad():
            for t, s in zip(self.tensors, getattr(self, "saved", [])):
                t.index_copy_(0, self.idx, s)
        return False


def _fold_sum(losses: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """(k,) valid-row sums in f32 (a select, so masked NaNs drop)."""
    return torch.where(mask > 0, losses.float(), 0.0).sum(1)


def _pick(t: torch.Tensor, folds: slice, rows) -> torch.Tensor:
    """This rank's part of a (k, B, ...) tensor: its group's ``folds``,
    its ``rows`` of each, contiguous (the gather kernel reads its indices
    in place)."""
    return t[folds][:, rows].contiguous()


def lockstep_train_step(stack: FoldStack, opt: FoldAdam, real, synth,
                        idx: torch.Tensor, mask: torch.Tensor, *,
                        mode: str, dtype: torch.dtype = torch.float32,
                        ratio: float = 0.0, n_real: int | None = None,
                        synth_pool=None, host_mask: np.ndarray | None = None,
                        generator: torch.Generator | None = None, flip=None,
                        use_synth=None, synth_pick=None, err=None,
                        grad_accum: int = 1, mesh=None,
                        folds: slice = slice(None)):
    """One step of every fold of ``stack``; returns (losses, preds,
    labels), each (k, B), on the device.

    ``idx`` (k, B) int64 rows of each fold's batch; ``mask`` (k, B) 0/1
    float validity (:func:`fold_masks`) on the device, ``host_mask`` the
    same on the host (read there without a sync; taken from ``mask``
    when missing); ``synth_pool`` (k, P): each fold's fallback pool. The
    draws, each (k, B), come from ``generator`` unless injected: the
    mixer's ``use_synth`` and ``synth_pick``, then ``flip``.

    Across ranks (``--parallel-folds`` under a launch): ``mesh`` is this
    rank's fold group (:meth:`MeshContext.split`), whose ranks share the
    batch rows of the stack's folds, ``folds`` of the (k, B) inputs. Every
    rank draws the whole (k, B) draws and takes its part of the inputs
    (``MeshContext.local_rows``), so that the group computes what one
    process computes: BN's statistics and each fold's loss denominator
    span the group's rows, and the gradients are summed over the group
    before :class:`FoldAdam`. The outputs are this rank's (k/f, B/n)
    part; whether a fold is active or a microbatch runs is read from the
    whole batch's mask, the same on every rank of the group."""
    if host_mask is None:
        host_mask = mask.cpu().numpy()
    dp = mesh is not None and mesh.distributed
    host_mask = host_mask[folds]
    k, b = host_mask.shape
    rows = mesh.local_rows(b, grad_accum) if dp else slice(None)
    shape = idx.shape
    if mode == "mix":  # the mixer's draws, whole (see mix_batch)
        if use_synth is None:
            use_synth = torch.rand(shape, generator=generator,
                                   device=idx.device) < ratio
        if synth_pick is None:
            n_pool = (synth_pool.shape[-1] if synth_pool is not None
                      else synth.images.shape[0])
            synth_pick = torch.randint(0, n_pool, shape, generator=generator,
                                       device=idx.device)
        use_synth = _pick(use_synth, folds, rows)
        synth_pick = _pick(synth_pick, folds, rows)
    active = host_mask.sum(1) > 0
    mask = _pick(mask, folds, rows)
    bn_mask = None if host_mask.all() else mask  # see the module docstring
    images, labels = assemble(
        mode, real, synth, _pick(idx, folds, rows), ratio=ratio,
        n_real=n_real, synth_pool=None if synth_pool is None
        else synth_pool[folds], use_synth=use_synth, synth_pick=synth_pick,
        err=err)
    if flip is None:
        flip = torch.rand(shape, generator=generator,
                          device=images.device) < 0.5
    images = random_flip(images, _pick(flip, folds, rows))
    x = normalize_images(images, dtype=dtype)
    opt.zero_grad()
    frozen = np.flatnonzero(~active)
    with _Keep(stack.fold_tensors() + opt.state_tensors(), frozen, k):
        if grad_accum > 1:
            losses, logits = _accum_grads(stack, x, labels, mask, host_mask,
                                          grad_accum, mesh)
        else:
            logits = stack(x, train=True, mask=bn_mask)
            losses = softmax_ce(logits.reshape(-1, logits.shape[-1]),
                                labels.reshape(-1)).reshape(mask.shape)
            w = mask.float()
            total = w.sum(1)
            if dp:
                total = mesh.all_reduce_(total)
            per_fold = (losses * w).sum(1) / torch.clamp(total, min=1e-9)
            per_fold.sum().backward()
        if dp:
            all_reduce_grads(stack.trainable, mesh)
        opt.step(active)
    return losses.detach(), logits.detach().argmax(-1), labels


def _accum_grads(stack: FoldStack, x, labels, mask, host_mask, accum: int,
                 mesh=None):
    """``grad_accum`` microbatches of B/A rows in every fold: the gradient
    of each fold's valid-row mean loss, accumulated; a fold's microbatch
    with no valid row adds nothing and leaves its BN statistics as they
    were. Returns the per-sample (losses, logits), zeros in microbatches
    that no fold ran. ``host_mask``: the whole (k, B) batch's; across a
    fold group (``mesh``) ``x``, ``labels`` and ``mask`` hold this rank's
    share of each microbatch (``MeshContext.local_rows(B, A)``)."""
    k, b = host_mask.shape
    if b % accum:
        raise ValueError(f"grad_accum={accum} must divide batch size {b}")
    mb = b // accum
    n = mesh.micro_rows(mb) if mesh is not None and mesh.distributed \
        else mb
    for p in stack.trainable:
        p.grad = torch.zeros_like(p)
    losses = x.new_zeros(mask.shape, dtype=torch.float32)
    logits = x.new_zeros((*mask.shape, stack.model.num_classes),
                         dtype=torch.float32)
    valid = host_mask.reshape(k, accum, mb).sum(2)
    for j in range(accum):
        if not valid[:, j].any():
            continue  # padding in every fold
        rows = slice(j * n, (j + 1) * n)
        idle = np.flatnonzero(valid[:, j] == 0)
        with _Keep([t for t in stack.buffers.values() if t.dim()], idle, k), \
                _Keep(stack.trainable, idle, k, grads=True):
            full = host_mask[:, j * mb:(j + 1) * mb].all()
            logits_mb = stack(x[:, rows], train=True,
                                    mask=None if full else mask[:, rows])
            losses_mb = softmax_ce(logits_mb.reshape(k * n, -1),
                                   labels[:, rows].reshape(-1)
                                   ).reshape(k, n)
            _fold_sum(losses_mb, mask[:, rows]).sum().backward()
        losses[:, rows] = losses_mb.detach()
        logits[:, rows] = logits_mb.detach()
    w_total = torch.clamp(torch.from_numpy(
        host_mask.sum(1).astype(np.float32)).to(x.device), min=1e-9)
    with torch.no_grad():
        for p in stack.trainable:
            fold_view(p.grad, k).div_(
                w_total.view(-1, *([1] * p.dim())))
    return losses, logits


@torch.no_grad()
def lockstep_eval_step(stack: FoldStack, store, idx: torch.Tensor, *,
                       dtype: torch.dtype = torch.float32, mesh=None,
                       folds: slice = slice(None)):
    """Running-statistics BN, no flip, every fold on its own (k, B) rows of
    ``store``. Returns (losses, preds, labels, prob1), each (k, B): across
    a fold group (``mesh``, ``folds`` as for :func:`lockstep_train_step`)
    this rank's part."""
    if mesh is not None and mesh.distributed:
        idx = _pick(idx, folds, mesh.local_rows(idx.shape[1]))
    labels = store.labels[idx]
    x = normalize_images(take_rows(store.images, idx), dtype=dtype)
    logits = stack(x, train=False)
    prob1 = torch.softmax(logits, dim=-1)[..., 1]
    losses = softmax_ce(logits.reshape(-1, logits.shape[-1]),
                        labels.reshape(-1)).reshape(idx.shape)
    return losses, logits.argmax(-1), labels, prob1
