"""The lockstep epoch loop of ``--parallel-folds`` (role of
xgan/train/parallel_cv.py; steps in :mod:`xgan_torch.train.parallel_folds`).

Every fold of a CV run trains at once: each epoch draws each fold's
batches from one numpy generator seeded ``--seed``
(:func:`fold_epoch_batches`, the JAX package's order), and one lockstep
step a batch advances all folds; the steps' draws come from one device
generator seeded ``--seed + 1000``. The artifacts are the sequential
path's: ``fold_{N}_{strategy}_training_history.json`` (the same keys;
the curriculum's ratio is shared by all folds), the best-validation
checkpoint ``fold_{N}_{strategy}_resnet50.pth`` of each fold, and, from
the caller, ``{strategy}_cv_summary.json`` and the figures. Padded rows
(each fold's wrap-padded tail and the batches a shorter fold repeats)
leave the metrics (:func:`_fold_metrics`). ``--trace-dir`` traces the
train phase of epoch ``trace_epoch(0, epochs)``, as the sequential loop
does. A SIGTERM or SIGINT stops the run at the end of its epoch with
every fold incomplete: no fold history and no summary are written, so a
rerun trains from scratch.
"""
from __future__ import annotations

import os
import time

import numpy as np
import torch

from xgan_torch.io_.metrics import write_json
from xgan_torch.kernels.gather import new_error_flag, raise_if_flagged
from xgan_torch.train.classifier import accuracy
from xgan_torch.train.classifier_loop import (STRATEGY_MODES, fallback_pool,
                                              init_resnet)
from xgan_torch.train.curriculum import get_current_synthetic_ratio
from xgan_torch.train.loop_common import (EpochProgress, GracefulShutdown,
                                          resolve_grad_accum, trace_epoch)
from xgan_torch.train.parallel_folds import (FoldAdam, FoldStack,
                                             fold_epoch_batches, fold_masks,
                                             lockstep_eval_step,
                                             lockstep_train_step)
from xgan_torch.utils.timer import maybe_trace


def _fold_metrics(outputs, n_valid):
    """Per-step (k, B) device tensors -> per-fold flat host arrays with
    the padding dropped (a fold's first ``n_valid`` flattened entries are
    its epoch, see :func:`fold_epoch_batches`)."""
    stacked = torch.stack(list(outputs)).cpu().numpy()  # (nb, k, B)
    return [stacked[:, f, :].reshape(-1)[:int(n_valid[f])]
            for f in range(stacked.shape[1])]


def fold_pools(real, splits) -> torch.Tensor:
    """The empty-synthetic fallback of every fold: each fold draws from
    its own train split's positives (``fallback_pool``), wrap-padded to a
    common length so that the pools stack as (k, P)."""
    pools = [fallback_pool(real, tr).cpu().numpy() for tr, _ in splits]
    m = max(p.size for p in pools)
    return torch.from_numpy(np.stack([np.resize(p, m) for p in pools])) \
        .to(real.images.device)


def run_parallel_cv(args, device, dtype, stores, splits, *, strategy,
                    schedule, synth_fallback: bool = False):
    """Train the ``splits`` (a (train, val) index pair per fold) in
    lockstep; ``stores``: the (real, synthetic, test) DeviceStores. Each
    fold's model is initialised from ``--seed`` plus its index, as on the
    sequential path. Returns (best state dict per fold, history per
    fold), or None when a signal stopped the run."""
    real, synth, _ = stores
    k = len(splits)
    mode = STRATEGY_MODES[strategy]
    synth_pools = None
    if mode == "mix" and synth_fallback:
        synth_pools = fold_pools(real, splits)
        synth = real  # the pools' values index the real store

    freeze = not args.unfreeze
    models = [init_resnet(args, dtype, device, args.seed + f)
              for f in range(k)]
    stack = FoldStack(models, [n for n, _ in models[0].named_parameters()
                               if not freeze or n.startswith("fc.")])
    del models
    opt = FoldAdam(stack.trainable, k, args.lr)
    ga = resolve_grad_accum(args.grad_accum, args.batch_size)
    print(f"Parallel CV: {k} folds in lockstep on {device}")

    n_real = len(real)
    if strategy == "augmented" and not synth_fallback:
        train_spaces = [np.concatenate([
            np.asarray(tr, np.int64),
            n_real + np.arange(len(synth), dtype=np.int64)])
            for tr, _ in splits]
    else:  # an empty synthetic store concatenates nothing
        train_spaces = [np.asarray(tr, np.int64) for tr, _ in splits]
    val_spaces = [np.asarray(va, np.int64) for _, va in splits]

    data_rng = np.random.default_rng(args.seed)
    generator = torch.Generator(device).manual_seed(args.seed + 1000)
    err = new_error_flag(device)
    histories = [{"epoch": [], "train_loss": [], "train_acc": [],
                  "val_loss": [], "val_acc": [], "synthetic_ratio": []}
                 for _ in range(k)]
    best_acc = [0.0] * k
    best_states = [stack.state_dict(f) for f in range(k)]
    with GracefulShutdown("parallel cross-validation") as shutdown:
        for epoch in range(args.epochs):
            t0 = time.time()
            ratio = 0.0
            if strategy == "curriculum" and schedule:
                ratio = get_current_synthetic_ratio(epoch, schedule)
            batches, n_valid = fold_epoch_batches(train_spaces,
                                                  args.batch_size, data_rng)
            if args.limit_batches:
                batches = batches[:args.limit_batches]
                n_valid = np.minimum(n_valid,
                                     batches.shape[0] * args.batch_size)
            masks = fold_masks(batches.shape[0], args.batch_size, n_valid)
            idx_all = torch.from_numpy(batches.astype(np.int64)).to(device)
            masks_dev = torch.from_numpy(masks).to(device)
            outputs = []
            traced = epoch == trace_epoch(0, args.epochs)
            with maybe_trace(args.trace_dir if traced else None), \
                    EpochProgress(f"Train Epoch {epoch + 1}",
                                  batches.shape[0]) as progress:
                for i in range(batches.shape[0]):
                    outputs.append(lockstep_train_step(
                        stack, opt, real, synth, idx_all[i], masks_dev[i],
                        host_mask=masks[i], mode=mode, dtype=dtype,
                        ratio=ratio, n_real=n_real, synth_pool=synth_pools,
                        generator=generator, err=err, grad_accum=ga))
                    progress.update(i + 1)
            tr = [_fold_metrics(col, n_valid) for col in zip(*outputs)]
            raise_if_flagged(err)

            val_batches, val_valid = fold_epoch_batches(
                val_spaces, args.batch_size, data_rng, shuffle=False)
            if args.limit_batches:
                val_batches = val_batches[:args.limit_batches]
                val_valid = np.minimum(val_valid,
                                       val_batches.shape[0] * args.batch_size)
            val_idx = torch.from_numpy(val_batches.astype(np.int64)) \
                .to(device)
            v_out = []
            with EpochProgress(f"Val Epoch {epoch + 1}",
                               val_batches.shape[0]) as progress:
                for i in range(val_batches.shape[0]):
                    v_out.append(lockstep_eval_step(stack, real, val_idx[i],
                                                    dtype=dtype)[:3])
                    progress.update(i + 1)
            va = [_fold_metrics(col, val_valid) for col in zip(*v_out)]

            for f in range(k):
                h = histories[f]
                h["epoch"].append(epoch + 1)
                h["synthetic_ratio"].append(
                    1.0 if strategy == "augmented" else ratio)
                h["train_loss"].append(float(tr[0][f].mean()))
                h["train_acc"].append(accuracy(tr[2][f], tr[1][f]))
                h["val_loss"].append(float(va[0][f].mean()))
                h["val_acc"].append(accuracy(va[2][f], va[1][f]))
                if h["val_acc"][-1] > best_acc[f]:
                    best_acc[f] = h["val_acc"][-1]
                    best_states[f] = stack.state_dict(f)
                    ckpt = os.path.join(
                        args.model_dir,
                        f"fold_{f + 1}_{strategy}_resnet50.pth")
                    torch.save(best_states[f], ckpt)
            mean_val = float(np.mean([h["val_acc"][-1] for h in histories]))
            print(f"Epoch {epoch + 1}/{args.epochs} [parallel {k}-fold "
                  f"{strategy}] ratio={ratio:.2f} mean val acc "
                  f"{mean_val:.4f} ({time.time() - t0:.1f}s)")
            if shutdown.requested and epoch + 1 < args.epochs:
                print(f"Preempted: parallel {k}-fold CV stopped after "
                      f"epoch {epoch + 1}/{args.epochs}; fold histories and "
                      "the CV summary are withheld (lockstep folds are all "
                      "incomplete); re-run to train from scratch.")
                return None

    for f in range(k):
        write_json(os.path.join(
            args.results_dir,
            f"fold_{f + 1}_{strategy}_training_history.json"), histories[f])
        print(f"Fold {f + 1} best val acc: {best_acc[f]:.4f}")
    return best_states, histories
