"""ResNet-50 fine-tuning: strategies x k-fold CV
(role of xgan/train/classifier_loop.py).

Strategies, named as in the reference:

- baseline    real data only;
- augmented   real + all synthetic, concatenated;
- curriculum  real-length epochs in which each item is replaced by a
              synthetic one with the epoch's scheduled probability.

K-fold splits are sklearn's ``KFold(shuffle=True, random_state=42)``,
rebuilt in numpy (:func:`kfold_splits`), so fold membership matches the
reference. The best-validation-accuracy model of each run is saved as
``{fold_N_}{strategy}_resnet50.pth`` in torchvision's layout; the history,
CV-summary and final-metrics JSON files keep the reference names and
keys, and the run's figures (``xgan_torch.io_.figures_classifier``) its
file names.

Per-step outputs stay on the device and are fetched once per epoch; the
epoch's index matrix goes to the device once. The ``mixed_gather`` error
flag is read once per epoch, after that fetch.

The loop flags, in the JAX loop's order: ``--grad-accum A`` (A
microbatches a step; a non-dividing A prints a note and runs as 1),
``--remat``/``--remat-scope`` (activation recompute in the ResNet),
``--trace-dir`` (one profiler trace of the train phase of the epoch
``trace_epoch(0, epochs)`` picks, in every run), and fold-level
``--resume-from auto``: a fold whose history JSON covers every epoch and
whose best checkpoint ``fold_{N}_{strategy}_resnet50.pth`` loads into
the flags' model is taken as trained, an incomplete one retrains, a
checkpoint that does not fit the flags is an ``Error:``. A first SIGTERM
or SIGINT stops the run at the end of its epoch (``GracefulShutdown``):
a stopped fold writes no history (so a resume retrains it), and a CV run
stopped before its last fold writes no summary. A single (non-CV) run
has no resume: it keeps its history and notes the stop.
"""
from __future__ import annotations

import json
import os
import time

import numpy as np
import torch

from xgan_torch.data import rsna
from xgan_torch.data.pipeline import DeviceStore, epoch_batches
from xgan_torch.data.store import ImageStore, decode_folder_store
from xgan_torch.io_.figures_classifier import generate_plots
from xgan_torch.io_.metrics import cv_summary, write_json
from xgan_torch.kernels.gather import new_error_flag, raise_if_flagged
from xgan_torch.models.convert import load_resnet_pth
from xgan_torch.models.resnet import ResNet50
from xgan_torch.train.classifier import (accuracy, auroc,
                                         classifier_optimizer, eval_step,
                                         train_step, weighted_prf)
from xgan_torch.train.curriculum import (get_current_synthetic_ratio,
                                         parse_curriculum_schedule)
from xgan_torch.train.loop_common import EpochProgress, GracefulShutdown, \
    batch_tail_mask, host_state, resolve_grad_accum, trace_epoch
from xgan_torch.utils import check_create_dir
from xgan_torch.utils.timer import maybe_trace

KFOLD_SEED = 42  # split parity with the reference's KFold
STRATEGY_MODES = {"baseline": "real", "augmented": "concat",
                  "curriculum": "mix"}


def kfold_splits(n: int, k: int, seed: int = KFOLD_SEED):
    """(train, test) index arrays of sklearn ``KFold(n_splits=k,
    shuffle=True, random_state=seed)``: the shuffled ``arange(n)`` cut
    into folds of ``n // k`` (one more in each of the first ``n % k``),
    each index set in ascending order."""
    order = np.arange(n)
    np.random.RandomState(seed).shuffle(order)
    sizes = np.full(k, n // k)
    sizes[:n % k] += 1
    splits, start = [], 0
    for size in sizes:
        test = np.zeros(n, bool)
        test[order[start:start + size]] = True
        splits.append((np.flatnonzero(~test), np.flatnonzero(test)))
        start += size
    return splits


def resnet_stages(args) -> tuple:
    """Hidden --resnet-stages override (tests shrink the net); the full
    ResNet-50 is (3, 4, 6, 3)."""
    return tuple(getattr(args, "resnet_stages", ()) or (3, 4, 6, 3))


def init_resnet(args, dtype, device, seed: int):
    if args.remat and args.remat_scope == "block":
        print("Note: --remat (block scope) recomputes each block's "
              "activations in the backward, about one more forward a step; "
              "--remat-scope stage and nested checkpoint other regions, "
              "and --grad-accum also lowers the activation peak.")
    model = ResNet50(2, stage_sizes=resnet_stages(args), dtype=dtype,
                     device=device,
                     generator=torch.Generator(device).manual_seed(seed),
                     remat=args.remat, remat_scope=args.remat_scope)
    if args.pretrained_path:
        load_resnet_pth(model, args.pretrained_path)
        print(f"Loaded ImageNet weights from {args.pretrained_path}")
    else:
        print("WARNING: no --pretrained-path given and torchvision weights "
              "cannot be downloaded here; training ResNet-50 from random "
              "init (throughput is unaffected; accuracy parity with the "
              "reference requires the ImageNet checkpoint).")
    return model


def _fetch(outputs, n: int):
    """Concatenate per-step device outputs, fetch them, drop padding."""
    return [torch.cat(list(col)).cpu().numpy()[:n] for col in zip(*outputs)]


def epoch_pass(model, opt, stores, batches, n_samples, *, mode, dtype,
               ratio, generator, err, synth_pool=None, label="Train",
               grad_accum: int = 1):
    """One train epoch over the (num_batches, B) index matrix; returns
    (loss, acc) over the first ``n_samples`` rows (the wrap-around padding
    dropped) and raises ``IndexError`` if the gather met a bad index."""
    real, synth = stores
    device = real.images.device
    num_batches, batch_size = batches.shape
    t_mask = batch_tail_mask(n_samples, num_batches, batch_size)
    if t_mask is not None:
        t_mask = torch.from_numpy(t_mask).to(device)
    idx_all = torch.from_numpy(batches.astype(np.int64)).to(device)
    outputs = []
    with EpochProgress(label, num_batches) as progress:
        for i in range(num_batches):
            is_tail = t_mask is not None and i == num_batches - 1
            outputs.append(train_step(
                model, opt, real, synth, idx_all[i], mode=mode, dtype=dtype,
                ratio=ratio, n_real=len(real), synth_pool=synth_pool,
                mask=t_mask if is_tail else None, generator=generator,
                err=err, grad_accum=grad_accum))
            progress.update(i + 1)
    losses, preds, labels = _fetch(outputs, n_samples)
    raise_if_flagged(err)
    return float(losses.mean()), accuracy(labels, preds)


def eval_pass(model, store, batches, n_samples, *, dtype,
              label="Evaluating"):
    device = store.images.device
    idx_all = torch.from_numpy(batches.astype(np.int64)).to(device)
    outputs = []
    with EpochProgress(label, batches.shape[0]) as progress:
        for i in range(batches.shape[0]):
            outputs.append(eval_step(model, store, idx_all[i], dtype=dtype))
            progress.update(i + 1)
    return _fetch(outputs, n_samples)


def evaluate_model(model, store: DeviceStore, batch_size: int, *, dtype):
    """Test-set metrics: the reference's keys plus ``auroc``."""
    n = len(store)
    batches = epoch_batches(n, batch_size, np.random.default_rng(0),
                            shuffle=False)
    losses, preds, labels, probs = eval_pass(model, store, batches, n,
                                             dtype=dtype)
    p, r, f = weighted_prf(labels, preds)
    metrics = {
        "loss": float(losses.mean()),
        "accuracy": accuracy(labels, preds),
        "weighted_precision": p,
        "weighted_recall": r,
        "weighted_f1_score": f,
        "auroc": auroc(labels, probs),
    }
    print(f"Evaluation Results - Loss: {metrics['loss']:.4f}, "
          f"Accuracy: {metrics['accuracy']:.4f}, "
          f"Weighted F1: {metrics['weighted_f1_score']:.4f}, "
          f"AUROC: {metrics['auroc']:.4f}")
    return metrics


def fallback_pool(real: DeviceStore, train_indices) -> torch.Tensor:
    """The reference's empty-synthetic fallback: a synthetic draw takes a
    random real POSITIVE of the run's train split (any of its rows if it
    has none), with its own label. Returns the (P,) int64 row pool into
    the real store, which the mixer draws through."""
    tr = np.asarray(train_indices, np.int64)
    pos = tr[real.labels_host[tr] == 1]
    pool = pos if pos.size else tr
    print("Curriculum fallback: substituting random real "
          f"{'positives' if pos.size else 'samples'} for the empty "
          "synthetic store.")
    return torch.from_numpy(pool).to(real.images.device)


def train_one_run(args, device, dtype, stores, train_indices, val_spec, *,
                  fold, strategy, schedule, seed_offset=0,
                  synth_fallback=False, shutdown=None):
    """Train one model (a fold or the single run). ``val_spec``:
    (DeviceStore, indices or None). Returns (best state dict on the host,
    history). ``shutdown``: a :class:`GracefulShutdown` read at each epoch
    boundary; a fold it stops writes no history (a resume then retrains
    it), the single run keeps its history."""
    real, synth, _ = stores
    mode = STRATEGY_MODES[strategy]
    synth_pool = None
    if mode == "mix" and synth_fallback:
        synth_pool = fallback_pool(real, train_indices)
        synth = real  # the pool's values index the real store
    seed = args.seed + seed_offset
    model = init_resnet(args, dtype, device, seed)
    opt = classifier_optimizer(model, args.lr, freeze_base=not args.unfreeze)
    generator = torch.Generator(device).manual_seed(seed + 1)
    err = new_error_flag(device)
    ga = resolve_grad_accum(args.grad_accum, args.batch_size)

    n_real = len(real)
    if strategy == "augmented" and not synth_fallback:
        epoch_space = np.concatenate([
            np.asarray(train_indices, np.int64),
            n_real + np.arange(len(synth), dtype=np.int64)])
    else:  # an empty synthetic store concatenates nothing
        epoch_space = np.asarray(train_indices, np.int64)
    val_store, val_indices = val_spec
    n_val = len(val_indices) if val_indices is not None else len(val_store)

    run_prefix = (f"fold_{fold}_" if fold is not None else "") \
        + f"{strategy}_"
    history = {"epoch": [], "train_loss": [], "train_acc": [],
               "val_loss": [], "val_acc": [], "synthetic_ratio": []}
    best_acc, best_state = 0.0, host_state(model)
    data_rng = np.random.default_rng(seed)

    for epoch in range(args.epochs):
        t0 = time.time()
        ratio = 0.0
        if strategy == "curriculum" and schedule:
            ratio = get_current_synthetic_ratio(epoch, schedule)
        elif strategy == "augmented":
            ratio = 1.0  # flag value, as in the reference
        history["epoch"].append(epoch + 1)
        history["synthetic_ratio"].append(ratio)

        batches = epoch_batches(len(epoch_space), args.batch_size, data_rng,
                                indices=epoch_space)
        if args.limit_batches:
            batches = batches[:args.limit_batches]
        n_seen = min(len(epoch_space), batches.size)
        traced = epoch == trace_epoch(0, args.epochs)
        with maybe_trace(args.trace_dir if traced else None):
            tr_loss, tr_acc = epoch_pass(
                model, opt, (real, synth), batches, n_seen, mode=mode,
                dtype=dtype, ratio=ratio, generator=generator, err=err,
                synth_pool=synth_pool, label=f"Train Epoch {epoch + 1}",
                grad_accum=ga)
        history["train_loss"].append(tr_loss)
        history["train_acc"].append(tr_acc)

        val_batches = epoch_batches(n_val, args.batch_size, data_rng,
                                    shuffle=False, indices=val_indices)
        n_val_seen = n_val
        if args.limit_batches:
            val_batches = val_batches[:args.limit_batches]
            n_val_seen = min(n_val, val_batches.size)
        v_losses, v_preds, v_labels, _ = eval_pass(
            model, val_store, val_batches, n_val_seen, dtype=dtype,
            label=f"Val Epoch {epoch + 1}")
        val_loss, val_acc = float(v_losses.mean()), accuracy(v_labels,
                                                             v_preds)
        history["val_loss"].append(val_loss)
        history["val_acc"].append(val_acc)
        print(f"Epoch {epoch + 1}/{args.epochs} [{run_prefix[:-1]}] "
              f"ratio={ratio:.2f} train {tr_loss:.4f}/{tr_acc:.4f} "
              f"val {val_loss:.4f}/{val_acc:.4f} "
              f"({time.time() - t0:.1f}s)")

        if val_acc > best_acc:
            best_acc, best_state = val_acc, host_state(model)
            ckpt = os.path.join(args.model_dir, f"{run_prefix}resnet50.pth")
            torch.save(best_state, ckpt)
            print(f"Saved best model checkpoint to {ckpt}")

        if stopped(shutdown, history, args.epochs):
            break

    if not (fold is not None and stopped(shutdown, history, args.epochs)):
        write_json(os.path.join(args.results_dir,
                                f"{run_prefix}training_history.json"),
                   history)
    print(f"Best val Acc: {best_acc:.4f}")
    return best_state, history


def stopped(shutdown, history: dict, epochs: int) -> bool:
    """A stop was asked for and the run has epochs left."""
    return (shutdown is not None and shutdown.requested
            and len(history["epoch"]) < epochs)


def load_completed_fold(args, fold: int, strategy: str):
    """Fold-level resume: (best state dict, history) of a fold that a
    prior run trained to the end, or None when its history or checkpoint
    is missing or its history is short (the fold retrains). Raises
    ``ValueError`` when the checkpoint does not fit the flags' model: a
    mismatch is never a silent retrain."""
    hist_path = os.path.join(
        args.results_dir, f"fold_{fold}_{strategy}_training_history.json")
    ckpt_path = os.path.join(args.model_dir,
                             f"fold_{fold}_{strategy}_resnet50.pth")
    if not (os.path.exists(hist_path) and os.path.exists(ckpt_path)):
        return None
    with open(hist_path) as f:
        history = json.load(f)
    if len(history.get("epoch", [])) < args.epochs:
        return None
    state = torch.load(ckpt_path, map_location="cpu", weights_only=True)
    try:
        ResNet50(2, stage_sizes=resnet_stages(args),
                 device="meta").load_state_dict(state, assign=True)
    except RuntimeError as e:
        raise ValueError(f"fold checkpoint {ckpt_path} does not match the "
                         f"current model flags ({e})") from None
    return state, history


def load_stores(args, device):
    """(real, synth, test) DeviceStores and the synthetic-fallback flag,
    or None after a printed error."""
    if not rsna.check_dataset_availability(args.data_dir):
        print(f"Error loading data: Dataset not available in "
              f"{args.data_dir}. Run `python src/download_dataset.py` "
              "first.")
        return None
    size, cache, workers = args.image_size, args.cache_dir, args.workers
    compiled = device.type == "cuda"  # the compiled PNG unfilter
    ids, labels = rsna.load_train_metadata(
        os.path.join(args.data_dir, "stage2_train_metadata.csv"))
    print(f"Decoding/loading {len(ids)} training images at {size}px "
          "(cached)...")
    t0 = time.perf_counter()
    train_store = ImageStore.build(rsna.train_paths(args.data_dir, ids),
                                   labels, size, cache_dir=cache,
                                   name=f"train{size}", workers=workers,
                                   compiled=compiled)
    test_ids, test_labels = rsna.load_test_metadata(
        os.path.join(args.data_dir, "stage2_test_metadata.csv"))
    test_store = ImageStore.build(rsna.test_paths(args.data_dir, test_ids),
                                  test_labels, size, cache_dir=cache,
                                  name=f"test{size}", workers=workers,
                                  compiled=compiled)

    synth_fallback = False
    if args.use_synthetic:
        if not os.path.isdir(args.synthetic_dir):
            print(f"Error loading data: synthetic dir {args.synthetic_dir} "
                  "is missing. Generate images first.")
            return None
        if not any(f.endswith(".png")
                   for f in os.listdir(args.synthetic_dir)):
            # the reference warns and goes on: curriculum substitutes
            # random real positives, augmentation concatenates nothing
            print("Warning: Synthetic dataset is empty or None.")
            synth_fallback = True
    if args.use_synthetic and not synth_fallback:
        synth_store = decode_folder_store(
            args.synthetic_dir, size, label=1, cache_dir=cache,
            name=f"synth{size}", workers=workers, compiled=compiled)
    else:  # a 1-image dummy keeps every mode's arguments the same
        synth_store = ImageStore(np.zeros((1, size, size, 3), np.uint8),
                                 np.ones((1,), np.int32), size)
    print(f"Stores ready in {time.perf_counter() - t0:.1f} s "
          f"(decode + resize, or the cache)")
    stores = tuple(DeviceStore(s, device)
                   for s in (train_store, synth_store, test_store))
    return stores, synth_fallback


def train_classifier(args, device: torch.device, dtype: torch.dtype):
    """Top-level flow (reference train_classifier.py:515-694). Returns the
    CV summary or the single run's metrics, or None after a printed
    error."""
    check_create_dir(args.model_dir)
    check_create_dir(args.results_dir)
    check_create_dir(args.figures_dir)

    schedule = None
    if args.use_curriculum:
        schedule = parse_curriculum_schedule(args.curriculum_schedule)
        print(f"Parsed curriculum schedule: {schedule}")
        if not schedule:
            print("Warning: empty schedule; using simple augmentation.")
            args.use_curriculum = False
    strategy = ("curriculum" if args.use_synthetic and args.use_curriculum
                and schedule else
                ("augmented" if args.use_synthetic else "baseline"))
    run_prefix = f"{strategy}_"

    if args.pretrained_path and not os.path.exists(args.pretrained_path):
        print(f"Error: pretrained checkpoint {args.pretrained_path} not "
              "found.")
        return None
    resume = args.resume_from
    if resume and resume != "auto":
        print("Error: the classifier supports only --resume-from auto "
              f"(fold-level resume); got {resume!r}.")
        return None
    if resume == "auto" and args.k_folds <= 1:
        print("Note: --resume-from auto has no effect on single (non-CV) "
              "classifier runs; training from scratch.")
    parallel = args.k_folds > 1 and args.parallel_folds
    if resume == "auto" and parallel:
        # fold-level resume skips completed folds, which exist only on the
        # sequential path
        print("Note: --resume-from auto has no effect with "
              "--parallel-folds (folds train in lockstep); "
              "training all folds from scratch.")
    loaded = load_stores(args, device)
    if loaded is None:
        return None
    stores, synth_fallback = loaded
    real, _, test = stores
    print(f"Device: {device}; compute dtype {dtype}; strategy {strategy}; "
          f"k_folds {args.k_folds}")
    eval_model = ResNet50(2, stage_sizes=resnet_stages(args), dtype=dtype,
                          device=device)

    def evaluate(state):
        eval_model.load_state_dict(state)
        return evaluate_model(eval_model, test, args.batch_size, dtype=dtype)

    def finish_cv(fold_metrics, fold_histories, title):
        """The folds' test metrics summarised: printed, written to
        ``{strategy}_cv_summary.json`` and plotted with the histories."""
        summary = cv_summary(fold_metrics)
        print(f"\n===== {title} =====")
        for k, v in summary["average"].items():
            print(f"Average {k}: {v:.4f} +/- {summary['std_dev'][k]:.4f}")
        write_json(os.path.join(args.results_dir,
                                f"{run_prefix}cv_summary.json"), summary)
        generate_plots(fold_histories, args.figures_dir, run_prefix,
                       cv_results=summary)
        return summary

    if parallel:
        from xgan_torch.train.parallel_cv import run_parallel_cv
        result = run_parallel_cv(
            args, device, dtype, stores, kfold_splits(len(real), args.k_folds),
            strategy=strategy, schedule=schedule,
            synth_fallback=synth_fallback)
        if result is None:  # stopped: no summary of incomplete folds
            return None
        fold_metrics = []
        for fold, state in enumerate(result[0]):
            print(f"--- Evaluating Fold {fold + 1} Model on Test Set ---")
            fold_metrics.append(evaluate(state))
        return finish_cv(fold_metrics, result[1],
                         "Cross-Validation Summary (parallel folds)")

    if args.k_folds > 1:
        fold_metrics, fold_histories = [], []
        # a completed fold's artifacts are on disk, so --resume-from auto
        # skips it; an incomplete fold retrains
        with GracefulShutdown("cross-validation") as shutdown:
            for fold, (tr_idx, val_idx) in enumerate(
                    kfold_splits(len(real), args.k_folds)):
                print(f"\n===== Fold {fold + 1} / {args.k_folds} =====")
                try:
                    done = (load_completed_fold(args, fold + 1, strategy)
                            if resume == "auto" else None)
                except ValueError as e:
                    print(f"Error: {e}")
                    return None
                if done is not None:
                    print(f"Resuming: fold {fold + 1} already trained; "
                          "loading its checkpoint and history.")
                    best_state, history = done
                else:
                    best_state, history = train_one_run(
                        args, device, dtype, stores, tr_idx,
                        (real, val_idx), fold=fold + 1, strategy=strategy,
                        schedule=schedule, seed_offset=fold,
                        synth_fallback=synth_fallback, shutdown=shutdown)
                if stopped(shutdown, history, args.epochs):
                    print(f"Preempted: fold {fold + 1} is incomplete and "
                          "will retrain on --resume-from auto; no summary "
                          "written.")
                    return None
                fold_histories.append(history)
                print(f"--- Evaluating Fold {fold + 1} Model on Test Set "
                      "---")
                fold_metrics.append(evaluate(best_state))
                if shutdown.requested and fold + 1 < args.k_folds:
                    print(f"Preempted: stopping after completed fold "
                          f"{fold + 1}; re-run with --resume-from auto to "
                          "train the remaining folds (no summary written).")
                    return None
        return finish_cv(fold_metrics, fold_histories,
                         "Cross-Validation Summary")

    # single run: the test set doubles as validation (reference behavior)
    print("Warning: using test set as validation for non-CV run.")
    with GracefulShutdown() as shutdown:
        best_state, history = train_one_run(
            args, device, dtype, stores, np.arange(len(real)), (test, None),
            fold=None, strategy=strategy, schedule=schedule,
            synth_fallback=synth_fallback, shutdown=shutdown)
    if stopped(shutdown, history, args.epochs):
        # no resume path for single runs: keep the partial artifacts
        print(f"Note: run preempted after epoch {len(history['epoch'])}"
              f"/{args.epochs}; metrics below reflect the best checkpoint "
              "reached so far.")
    metrics = evaluate(best_state)
    write_json(os.path.join(args.results_dir,
                            f"{run_prefix}final_metrics.json"),
               {"config": vars(args), "metrics": metrics})
    generate_plots([history], args.figures_dir, run_prefix)
    return metrics
