"""Epoch-loop helpers of the trainers (role of
xgan/train/loop_common.py): the batch plan, checkpoints, the sample
cadence, preemption, resume (:class:`EpochRun`, which the three GAN loops
share) and the progress line."""
from __future__ import annotations

import json
import os
import signal
import sys
import time
import types

import numpy as np
import torch

from xgan_torch.data.pipeline import epoch_batches
from xgan_torch.io_.metrics import write_json
from xgan_torch.parallel import tp
from xgan_torch.train.snapshot import SnapshotManager, resume_run, \
    run_state, save_epoch
from xgan_torch.utils.timer import maybe_trace


def batch_tail_mask(n_valid: int, num_batches: int, batch_size: int):
    """0/1 float32 validity mask of an epoch's final batch, or None when
    that batch is full. ``epoch_batches`` wrap-pads the last batch, so its
    padded rows are its tail; the mask gives the step the reference
    DataLoader's smaller final batch for the loss, the gradient and the BN
    statistics. With --limit-batches the kept batches are all full."""
    pad = num_batches * batch_size - n_valid
    if pad <= 0:
        return None
    return np.concatenate([np.ones(batch_size - pad, np.float32),
                           np.zeros(pad, np.float32)])


def epoch_plan(n_valid: int, batch_size: int, data_rng,
               limit_batches: int, device: torch.device):
    """One epoch's batches on ``device``: the ``(num_batches, B)`` int64
    row indices in the JAX package's order (``epoch_batches``, cut to
    ``limit_batches`` when set) and the final batch's validity mask
    (:func:`batch_tail_mask`), or None when that batch is full."""
    batches = epoch_batches(n_valid, batch_size, data_rng)
    if limit_batches:
        batches = batches[:limit_batches]
    t_mask = batch_tail_mask(n_valid, batches.shape[0], batch_size)
    if t_mask is not None:
        t_mask = torch.from_numpy(t_mask).to(device)
    return torch.from_numpy(batches.astype(np.int64)).to(device), t_mask


def epoch_dispatches(num_batches: int, has_tail: bool, k: int):
    """``(i, chunk)`` of an epoch's calls from batch ``i``: chunks of ``k``
    full batches while they fit (``--steps-per-call``), the rest (the
    masked tail among them) one step a call."""
    chunkable = num_batches - (1 if has_tail else 0)
    i = 0
    while i < num_batches:
        chunk = k if k > 1 and i + k <= chunkable else 1
        yield i, chunk
        i += chunk


def resolve_grad_accum(grad_accum: int, batch_size: int) -> int:
    """``--grad-accum``, or 1 after the JAX package's note when it does
    not divide the batch."""
    ga = max(1, grad_accum)
    if ga > 1 and batch_size % ga:
        print(f"Note: --grad-accum {ga} does not divide the "
              f"(device-padded) batch size {batch_size}; running "
              "without accumulation.")
        ga = 1
    return ga


def save_gan_checkpoints(model_dir: str, tag: str, g, d) -> None:
    """``generator_{tag}.pth`` and ``discriminator_{tag}.pth``: the
    reference-layout state dicts ``g`` and ``d`` (:func:`host_state`'s)."""
    torch.save(g, os.path.join(model_dir, f"generator_{tag}.pth"))
    torch.save(d, os.path.join(model_dir, f"discriminator_{tag}.pth"))


def host_state(model) -> dict:
    """A copy of ``model``'s whole state dict on the host (a checkpoint
    that later steps do not change); under tensor parallelism a
    collective of its model group, which assembles the slices."""
    return {k: v.detach().cpu().clone()
            for k, v in tp.whole_state_dict(model).items()}


def grid_iters(iters: int, chunk: int, save_interval: int,
               last_epoch: bool, i: int, num_batches: int) -> list[int]:
    """Iterations in ``[iters, iters + chunk)`` (the ``i``-th batch of
    its epoch onwards) whose sample sheet is due: every ``save_interval``
    iterations, as the reference (train_gan.py:166-169), and the final
    iteration of the final epoch. A chunk of K steps per call renders the
    same post-chunk state for every due iteration in it, so only the last
    due one gets a sheet: at most one per dispatch."""
    due = [t for t in range(iters, iters + chunk)
           if t % save_interval == 0
           or (last_epoch and i + (t - iters) == num_batches - 1)]
    return due[-1:]


class GracefulShutdown:
    """SIGTERM/SIGINT -> checkpoint at the epoch boundary -> exit 0.

    Between :meth:`install` and :meth:`restore` the FIRST signal only
    sets ``requested``; the loops read it at their epoch boundary
    (:func:`checkpoint_boundary`), save a snapshot even off
    ``--checkpoint-interval``, and return, so a rerun with
    ``--resume-from auto`` continues the run. A SECOND signal raises
    KeyboardInterrupt at once; the loops' ``finally`` still flushes the
    queued snapshot writes. Off the main thread (where ``signal.signal``
    raises) it is an inert flag. :meth:`restore` puts back the previous
    handlers."""

    def __init__(self, what: str = "training"):
        self.requested = False
        self._what = what
        self._prev = {}

    def install(self):
        try:
            for sig in (signal.SIGTERM, signal.SIGINT):
                self._prev[sig] = signal.signal(sig, self._handle)
        except ValueError:  # not the main thread: an inert flag
            self._prev = {}
        return self

    def __enter__(self):
        return self.install()

    def _handle(self, signum, frame):
        if self.requested:  # second signal: unwind now
            raise KeyboardInterrupt
        self.requested = True
        # os.write, not print(): a signal that lands while the main thread
        # is inside a buffered stdout write would make print() raise
        # "reentrant call" in the middle of the epoch
        os.write(2, (f"\nReceived signal {signum}: will checkpoint and "
                     f"stop {self._what} at the end of this epoch "
                     "(signal again to abort immediately).\n").encode())

    def restore(self):
        for sig, prev in self._prev.items():
            signal.signal(sig, prev)
        self._prev = {}

    def __exit__(self, *exc):
        self.restore()
        return False


def checkpoint_boundary(shutdown: GracefulShutdown, epoch: int,
                        epochs: int, interval: int, save) -> bool:
    """The epoch-boundary checkpoint and the stop decision of the GAN
    loops. Reads ``shutdown.requested`` once, so that the same value
    forces the off-interval save and decides the stop (two reads would let
    a signal between them stop the loop without the snapshot the preempt
    notice promises). Calls ``save()`` every ``interval`` epochs, after
    the final epoch and on a stop; returns True when the loop should stop
    early."""
    stop = bool(shutdown.requested)
    if (epoch + 1) % interval == 0 or (epoch + 1) == epochs or stop:
        save()
    return stop and (epoch + 1) < epochs


def preempt_notice(preempted_epoch: int) -> None:
    """The message of a preempted GAN run."""
    print(f"Preempted: training stopped after epoch {preempted_epoch} "
          "with a resumable snapshot; re-run with --resume-from auto "
          "to continue.")


def resume_history(history_path: str, history: dict, start_epoch: int):
    """On resume, the prior run's history JSON, so that the final file
    covers every epoch; a fresh run (or one whose keys differ) keeps the
    empty ``history``."""
    if start_epoch and os.path.exists(history_path):
        with open(history_path) as f:
            prior = json.load(f)
        if set(prior) == set(history):
            return prior
    return history


def replay_data_rng(n: int, batch_size: int, data_rng, start_epoch: int):
    """Advance the numpy batch-order generator past the epochs already
    trained, so that a resumed run sees the batches it would have."""
    for _ in range(start_epoch):
        epoch_batches(n, batch_size, data_rng)


def resume_preflight(args) -> bool:
    """False after a printed error when an explicit ``--resume-from``
    path does not exist, before the dataset is decoded; ``auto`` and
    ``""`` pass."""
    r = getattr(args, "resume_from", "")
    if r and r != "auto" and not os.path.exists(r):
        print(f"Error: snapshot {r} not found (use --resume-from auto to "
              "start fresh when no snapshot exists)")
        return False
    return True


def trace_epoch(start_epoch: int, epochs: int) -> int:
    """The epoch ``--trace-dir`` traces: the second of this process (the
    first one warms up), or the only one left on a short run."""
    return min(start_epoch + 1, epochs - 1)


def ema_state(g, ema) -> dict | None:
    """``g``'s whole state dict with the EMA parameters and the raw
    generator's BN buffers (already a running average), on the host; None
    without EMA. A collective of the model group under tensor
    parallelism."""
    if ema is None:
        return None
    sd = host_state(g)
    sd.update({k: v.detach().cpu().clone()
               for k, v in tp.whole_state_dict(g, ema).items()})
    return sd


def save_ema_final(model_dir: str, sd) -> None:
    """``generator_ema_final.pth``: the EMA state dict ``sd``
    (:func:`ema_state`'s), loadable by the samplers as is. No-op without
    EMA."""
    if sd is None:
        return
    path = os.path.join(model_dir, "generator_ema_final.pth")
    torch.save(sd, path)
    print(f"Saved EMA generator to {path}")


class EpochRun:
    """The run-level part of the three GAN loops, in the JAX loops'
    order. ``models``/``opts``: name -> module / optimizer (``g`` and
    ``d`` or ``c``); ``ema``: the EMA dict or None; ``rng``: the
    step-draw generator.

    - :meth:`resume`: ``--resume-from`` restores them in place from
      ``{model_dir}/snapshot_last.pth``, replays the batch order past the
      trained epochs and merges the prior history (``self.history``);
    - between ``__enter__`` and ``__exit__`` a first SIGTERM/SIGINT asks
      for a stop at the epoch boundary (:class:`GracefulShutdown`);
      ``__exit__`` flushes the queued writes on every exit path, then
      gives the handlers back;
    - :meth:`traced` is the profiler window of ``--trace-dir``'s epoch;
    - :meth:`boundary` saves the epoch's checkpoints, snapshot and history
      through the async writer and says whether to stop (``preempted``);
    - :meth:`save_final` writes the final checkpoints, the EMA generator
      and the history.

    ``mesh``: the data-parallel ranks of the run (None: one). Every rank
    resumes from the snapshot, only rank 0 writes and traces, and the
    ranks agree at each boundary (an all-reduced flag, also their
    barrier): a signal to any rank stops them all there."""

    def __init__(self, args, model_dir: str, history_path: str,
                 history: dict, models: dict, opts: dict, ema,
                 rng: torch.Generator, mesh=None):
        self.args = args
        self.mesh = mesh
        self.is_main = mesh is None or mesh.is_main
        self.model_dir, self.history_path = model_dir, history_path
        self.history = history
        self.models, self.opts, self.ema, self.rng = models, opts, ema, rng
        self.snapshots = SnapshotManager(
            os.path.join(model_dir, "snapshot_last.pth"),
            async_io=True)  # overlap the next epoch
        self.shutdown = GracefulShutdown()
        self.start_epoch = self.iters = self.preempted = 0

    def resume(self, n_train: int, batch_size: int, data_rng) -> bool:
        """False after a printed error (a missing explicit path, a
        snapshot that does not fit the flags)."""
        try:
            self.start_epoch, self.iters = resume_run(
                self.snapshots, self.args.resume_from, self.models,
                self.opts, self.ema, self.rng)
        except (FileNotFoundError, ValueError) as e:
            print(f"Error: {e}")
            return False
        replay_data_rng(n_train, batch_size, data_rng, self.start_epoch)
        self.history = resume_history(self.history_path, self.history,
                                      self.start_epoch)
        return True

    def epochs(self) -> range:
        return range(self.start_epoch, self.args.epochs)

    def traced(self, epoch: int):
        """``maybe_trace`` of ``--trace-dir`` at :func:`trace_epoch`, a
        no-op at every other epoch."""
        on = (self.args.trace_dir and self.is_main and epoch ==
              trace_epoch(self.start_epoch, self.args.epochs))
        return maybe_trace(self.args.trace_dir if on else None)

    def boundary(self, epoch: int, iters: int) -> bool:
        """:func:`checkpoint_boundary` with the epoch's writes; True (and
        ``preempted`` set) when the loop should stop."""
        shutdown = self.shutdown
        if self.mesh is not None:  # one value, agreed by every rank
            shutdown = types.SimpleNamespace(
                requested=self.mesh.any(shutdown.requested))

        def save():
            # every rank: a ZeRO-1 optimizer's state dict assembles its
            # moments with a collective
            states = run_state(self.models, self.opts, self.ema, self.rng)
            if self.is_main:
                save_epoch(self.snapshots, self.model_dir, epoch + 1, iters,
                           self.models, self.history_path, self.history,
                           states)

        stop = checkpoint_boundary(shutdown, epoch, self.args.epochs,
                                   self.args.checkpoint_interval, save)
        if stop:
            self.preempted = epoch + 1  # its snapshot is queued
        return stop

    def __enter__(self):
        self.shutdown.install()
        return self

    def __exit__(self, exc_type, *exc):
        # land the queued writes on every exit path, before the handlers
        # go back: a second signal while they drain must still be ours
        try:
            self.snapshots.flush(reraise=exc_type is None)
        finally:
            self.shutdown.restore()
        return False

    def save_final(self) -> None:
        """``{generator,discriminator}_final.pth``, the EMA generator and
        the history JSON (rank 0; every rank assembles them)."""
        g, second = self.models.values()
        states = [host_state(g), host_state(second), ema_state(g, self.ema)]
        if not self.is_main:
            return
        save_gan_checkpoints(self.model_dir, "final", *states[:2])
        save_ema_final(self.model_dir, states[2])
        print(f"Saved final models to {self.model_dir}")
        write_json(self.history_path, self.history)


def gan_live_postfix(m) -> str:
    """DCGAN step metrics [G, D, D_x, D_G_z1, D_G_z2] ((5,) of one step or
    (K, 5) of a K-step call) for the progress line."""
    m = np.atleast_2d(m)[-1]
    return f"Loss_D: {m[1]:.4f}, Loss_G: {m[0]:.4f}, D(x): {m[2]:.4f}"


def wgan_live_postfix(m) -> str:
    """WGAN-GP step losses [d_1, ..., d_n, g] for the progress line: the
    last critic loss, as the JAX package shows it."""
    return f"Loss_D: {m[-2]:.4f}"


class EpochProgress:
    """In-epoch progress line that never waits for the device: it counts
    batches dispatched and their rate. Writes only to a terminal and
    redraws at most ~10 times a second.

    With ``postfix_fn``, the line also shows a recent step's metrics: at
    a redraw the step's metrics are copied to the host without blocking,
    and shown at a later redraw once that copy has landed."""

    def __init__(self, label: str, num_batches: int, postfix_fn=None):
        self.enabled = sys.stdout.isatty()
        self.label = label
        self.total = num_batches
        self.t0 = time.time()
        self._last = 0.0
        self.postfix_fn = postfix_fn
        self.postfix = ""
        self._pending = None  # (host copy, CUDA event or None)

    def update(self, i: int, metrics: torch.Tensor | None = None) -> None:
        if not self.enabled:
            return
        now = time.time()
        if now - self._last < 0.1 and i < self.total:
            return
        if self.postfix_fn is not None and metrics is not None:
            self._poll(metrics)
        rate = i / max(now - self.t0, 1e-9)
        sys.stdout.write(f"\r{self.label}: {i}/{self.total} batches "
                         f"dispatched ({rate:.1f}/s){self.postfix}")
        sys.stdout.flush()
        self._last = now

    def _poll(self, metrics: torch.Tensor) -> None:
        if self._pending is not None:
            host, done = self._pending
            if done is None or done.query():
                self.postfix = ", " + self.postfix_fn(host.numpy())
                self._pending = None
        if self._pending is None:
            on_cuda = metrics.is_cuda
            host = torch.empty(metrics.shape, dtype=metrics.dtype,
                               pin_memory=on_cuda)
            host.copy_(metrics, non_blocking=on_cuda)
            done = None
            if on_cuda:
                done = torch.cuda.Event()
                done.record()
            self._pending = (host, done)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        if self.enabled:  # clear the line, also when a step raised
            sys.stdout.write("\r\x1b[2K")
            sys.stdout.flush()
        return False
