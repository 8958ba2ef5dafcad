"""Classifier train and eval steps (role of xgan/train/classifier.py).

One train step assembles the batch on the device from one of three
sources (the real store; the real+synthetic concat; the curriculum mix),
flips and normalizes it, runs the ResNet forward with train-mode BN, takes
the validity-weighted mean of the per-sample cross-entropy, and applies
one Adam update. The concat and mix sources build their images with the
``mixed_gather`` kernel. Per-sample losses, predictions and labels stay
on the device; the loop fetches them once per epoch.

Freezing the base (the reference default; ``--unfreeze`` lifts it) makes
Adam see ``fc`` only, and the base's parameters ``requires_grad_(False)``,
while BN stays in train mode: its running statistics advance as in a
frozen torch backbone under ``model.train()``. This equals the JAX
package's optax ``set_to_zero`` on the base (Adam on zero gradients never
moves a parameter), and skips a backward that would update nothing.

``grad_accum=A > 1`` (``--grad-accum``; ``_microbatch_grads`` of the
JAX package) assembles, flips and normalizes the batch once, on the full
batch (one ``mixed_gather`` launch; across ranks each rank's share of
every microbatch, its rows copied into one contiguous index for that one
launch), then runs A microbatches of B/A rows
through the forward and the backward of their valid-row loss *sum*, BN
statistics per microbatch (torch gradient accumulation); the summed
gradient is divided by the batch's valid rows before the one optimizer
step. A microbatch whose rows are all padding is skipped: its statistics
stay frozen, it adds no gradient, and its rows' outputs are zeros (the
loop drops padded rows).

Across data-parallel ranks (``mesh``, a joined process group; the model's
BN tied to it by ``sync_batch_norm``) the index batch and the draws are
the global batch's on every rank (the mixer's ``use_synth`` and
``synth_pick``, then ``flip``), and each rank trains on its rows
(``MeshContext.local_rows``): its loss is its valid-row sum over the
all-reduced valid count, the gradients are summed over the ranks in one
buffer before Adam, and the per-sample outputs come back for the whole
batch on every rank (``MeshContext.gather_rows``), as from the JAX
package's sharded step. Under ``--model-parallel`` ``mesh`` is the data
group (its model group rides along): the rows, the valid count, the
gradient sum and the gathered outputs are the data group's, the model
computes column-parallel over its model group
(:mod:`xgan_torch.parallel.tp`), and ``mixed_gather_ranks`` gathers the
data group's rows on each of its ranks.

The metrics replace sklearn's with numpy and scipy:
:func:`weighted_prf` (support-weighted precision, recall and F1 with
``zero_division=0``), :func:`accuracy` and :func:`auroc` (the rank
statistic with average ranks for ties; 0.5 for a single-class set).
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from scipy.stats import rankdata

from xgan_torch.data.mixer import mix_batch
from xgan_torch.data.pipeline import normalize_images, random_flip, \
    take_rows
from xgan_torch.kernels.gather import mixed_gather_ranks
from xgan_torch.ops.reduce import weighted_mean
from xgan_torch.parallel.mesh import all_reduce_grads
from xgan_torch.train.common import guarded_sum, microbatches, zeroed_grads

MODES = ("real", "concat", "mix")


def classifier_optimizer(model, lr: float, freeze_base: bool):
    """Adam(lr, eps 1e-8) over all parameters, or over ``fc`` only with
    the rest of the model set ``requires_grad_(False)``."""
    for name, p in model.named_parameters():
        p.requires_grad_(not freeze_base or name.startswith("fc."))
    return torch.optim.Adam([p for p in model.parameters()
                             if p.requires_grad], lr=lr, eps=1e-8)


def softmax_ce(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Per-sample cross-entropy in f32 (torch's reduction='none')."""
    return F.cross_entropy(logits.float(), labels, reduction="none")


def gather_concat(real_images, real_labels, synth_images, synth_labels,
                  idx, *, n_real: int, err=None, rows: slice = slice(None),
                  real_take=None, synth_take=None):
    """Virtual concat of the real and synthetic stores: an index below
    ``n_real`` is a real row, the others synthetic row ``idx - n_real``
    (ConcatDataset order, without building the combined array).
    ``rows``, ``real_take`` and ``synth_take`` as for ``mix_batch``."""
    is_real = idx < n_real
    r_idx = torch.where(is_real, idx, 0)
    s_idx = torch.where(is_real, 0, idx - n_real)
    if real_take is None and synth_take is None:
        images = mixed_gather_ranks(real_images, synth_images, r_idx, s_idx,
                                    ~is_real, rows, err)
    else:
        images = torch.where(
            is_real[rows][:, None, None, None],
            (real_take or take_rows)(real_images, r_idx, rows),
            (synth_take or take_rows)(synth_images, s_idx, rows))
    is_real, r_idx, s_idx = is_real[rows], r_idx[rows], s_idx[rows]
    labels = torch.where(is_real, real_labels[r_idx], synth_labels[s_idx])
    return images, labels


def assemble(mode: str, real, synth, idx, *, ratio: float = 0.0,
             n_real: int | None = None, synth_pool=None, generator=None,
             use_synth=None, synth_pick=None, err=None,
             rows: slice = slice(None)):
    """The u8 batch and its labels from the mode's source. ``real`` and
    ``synth`` are DeviceStores; ``idx`` is the (B,) int64 batch on their
    device, of which ``rows`` are built (a rank's rows). A store split
    over the ranks turns the ``mixed_gather`` kernel off for its own
    gathers and a select."""
    takes = {}
    if real.sharded or synth.sharded:
        takes = {"real_take": real.take, "synth_take": synth.take}
    if mode == "real":
        return (real.take(real.images, idx, rows),
                real.labels[idx[rows]])
    if mode == "concat":
        return gather_concat(real.images, real.labels, synth.images,
                             synth.labels, idx,
                             n_real=len(real) if n_real is None else n_real,
                             err=err, rows=rows, **takes)
    if mode == "mix":
        return mix_batch(real.images, real.labels, idx, synth.images,
                         synth.labels, ratio, synth_pool=synth_pool,
                         generator=generator, use_synth=use_synth,
                         synth_pick=synth_pick, err=err, rows=rows, **takes)
    raise ValueError(f"mode must be one of {MODES}, got {mode!r}")


def _dp(mesh) -> bool:
    return mesh is not None and mesh.distributed


def _rows(mesh, b: int, accum: int = 1):
    return mesh.local_rows(b, accum) if _dp(mesh) else slice(None)


def train_step(model, opt, real, synth, idx, *, mode: str,
               dtype: torch.dtype = torch.float32, ratio: float = 0.0,
               n_real: int | None = None, synth_pool=None, mask=None,
               generator: torch.Generator | None = None, flip=None,
               use_synth=None, synth_pick=None, err=None,
               grad_accum: int = 1, mesh=None):
    """One optimizer step; returns per-sample (losses, preds, labels) as
    device tensors (no host sync unless ``grad_accum > 1`` and a ``mask``
    is given: it then reads which microbatches hold valid rows).

    ``mask``: (B,) 0/1 float validity of a padded tail batch; padded rows
    leave the loss mean and the BN statistics (their per-sample outputs
    are still returned; the loop drops them). Random draws come from
    ``generator`` on the device unless injected: the mixer's ``use_synth``
    and ``synth_pick`` first, then the ``flip`` mask. ``grad_accum``:
    microbatches per step (it must divide B). ``mesh``: the step of one
    data-parallel rank (see the module docstring)."""
    b = idx.shape[0]
    rows = _rows(mesh, b, grad_accum)
    images, labels = assemble(mode, real, synth, idx, ratio=ratio,
                              n_real=n_real, synth_pool=synth_pool,
                              generator=generator, use_synth=use_synth,
                              synth_pick=synth_pick, err=err, rows=rows)
    if flip is None:
        flip = torch.rand((b,), generator=generator,
                          device=images.device) < 0.5
    images = random_flip(images, flip[rows])
    x = normalize_images(images, dtype=dtype)
    if mask is not None:
        mask = mask[rows]
    opt.zero_grad(set_to_none=True)
    if grad_accum > 1:
        losses, logits = microbatch_grads(model, x, labels, mask, grad_accum,
                                          b, mesh)
    else:
        logits = model(x, train=True, mask=mask)
        losses = softmax_ce(logits, labels)
        weighted_mean(losses, mask, mesh).backward()
    all_reduce_grads([p for p in model.parameters() if p.requires_grad],
                     mesh)
    opt.step()
    preds = logits.detach().argmax(-1)
    if not _dp(mesh):
        return losses.detach(), preds, labels
    out = mesh.gather_rows(torch.stack(
        [losses.detach(), preds.float(), labels.float()], 1), b, rows)
    return out[:, 0], out[:, 1].long(), out[:, 2].long()


def microbatch_grads(model, x, labels, mask, accum: int,
                     b: int | None = None, mesh=None):
    """The gradient of the valid-row mean loss of ``model`` on the
    normalized batch ``x``, accumulated over ``accum`` microbatches into
    the ``.grad`` of its trainable parameters; returns the per-sample
    (losses, logits), zeros for the rows of a skipped microbatch.
    ``mesh``: ``x`` holds this rank's rows of the global batch of ``b``
    (``MeshContext.local_rows(b, accum)``), and the gradient is this
    rank's part of the global one (``microbatches``)."""
    w_total, micro = microbatches(mask, x.shape[0] if b is None else b,
                                  accum, mesh)
    grads = zeroed_grads([p for p in model.parameters() if p.requires_grad])
    losses = x.new_zeros(x.shape[0], dtype=torch.float32)
    logits = x.new_zeros((x.shape[0], model.fc.out_features),
                         dtype=torch.float32)
    for rows, mask_mb in micro:
        logits_mb = model(rows(x), train=True, mask=mask_mb)
        losses_mb = softmax_ce(logits_mb, rows(labels))
        guarded_sum(losses_mb, mask_mb).backward()
        rows(losses).copy_(losses_mb.detach())
        rows(logits).copy_(logits_mb.detach())
    torch._foreach_div_(grads, w_total)
    return losses, logits


@torch.no_grad()
def eval_step(model, store, idx, *, dtype: torch.dtype = torch.float32,
              mesh=None):
    """Running-statistics BN, no flip. Returns per-sample (losses, preds,
    labels, prob1), where prob1 is the positive-class probability.
    ``mesh``: each rank evaluates its rows, and every rank gets the whole
    batch's outputs."""
    b = idx.shape[0]
    rows = _rows(mesh, b)
    labels = store.labels[idx[rows]]
    x = normalize_images(store.take(store.images, idx, rows), dtype=dtype)
    logits = model(x, train=False)
    prob1 = torch.softmax(logits, dim=-1)[:, 1]
    losses, preds = softmax_ce(logits, labels), logits.argmax(-1)
    if not _dp(mesh):
        return losses, preds, labels, prob1
    out = mesh.gather_rows(torch.stack(
        [losses, preds.float(), labels.float(), prob1.float()], 1), b)
    return out[:, 0], out[:, 1].long(), out[:, 2].long(), out[:, 3]


def accuracy(labels, preds) -> float:
    return float(np.mean(np.asarray(labels) == np.asarray(preds)))


def weighted_prf(labels, preds) -> tuple[float, float, float]:
    """Support-weighted precision, recall and F1 over the classes present
    in ``labels`` or ``preds``, 0 where a ratio's denominator is 0
    (sklearn ``precision_recall_fscore_support(average="weighted",
    zero_division=0)``)."""
    labels, preds = np.asarray(labels), np.asarray(preds)
    classes = np.union1d(labels, preds)
    tp = np.array([np.sum((labels == c) & (preds == c)) for c in classes],
                  np.float64)
    true = np.array([np.sum(labels == c) for c in classes], np.float64)
    pred = np.array([np.sum(preds == c) for c in classes], np.float64)

    def div(a, b):
        return np.divide(a, b, out=np.zeros_like(a), where=b != 0)

    scores = (div(tp, pred), div(tp, true), div(2 * tp, true + pred))
    return tuple(float(np.average(s, weights=true)) for s in scores)


def auroc(labels, scores) -> float:
    """Area under the ROC curve as the rank statistic, with average ranks
    for tied scores; 0.5 when ``labels`` hold a single class."""
    labels = np.asarray(labels)
    pos = labels == 1
    n_pos, n_neg = int(pos.sum()), int((~pos).sum())
    if n_pos == 0 or n_neg == 0:
        return 0.5
    ranks = rankdata(np.asarray(scores, np.float64))
    return float((ranks[pos].sum() - n_pos * (n_pos + 1) / 2)
                 / (n_pos * n_neg))
