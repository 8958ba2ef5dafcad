"""Full-state training snapshots (role of xgan/train/snapshot.py).

A snapshot is one ``torch.save`` file, ``{model_dir}/{gan,wgan,cgan}/
snapshot_last.pth``, where the JAX package writes ``.msgpack``. It holds
what a run needs to continue as if it had never stopped (see
:func:`run_state`): the reference-layout state dicts of G and D (or the
critic), both optimizers' ``state_dict()``, the generator EMA when
``--ema-decay`` is on, the state of the ``torch.Generator`` the steps draw
from (``rng``), and the ``epoch`` and ``iters`` counters. The JAX package
draws each step's randomness statelessly from ``fold_in(key, iters)``;
the port draws it from one generator, so its state is part of the run.

``async_io=True`` overlaps the write with the next epoch. The optimizers
update the parameters in place, so :meth:`SnapshotManager.save` copies the
state at the call, in order on the compute stream: each CUDA tensor is
copied without blocking into pinned host memory, and an event recorded
after the copies is what the writer thread waits on before it touches the
bytes. CPU tensors are cloned. One FIFO thread (:class:`AsyncWriter`)
writes the snapshot, the epoch checkpoints and the history JSON in the
order they were submitted, so the history never lands before its
snapshot. A write goes to a temporary file that ``os.replace`` puts in
place: a crash mid-write leaves the previous snapshot intact.

Under tensor parallelism a snapshot holds every tensor whole, in the
reference layouts (:func:`run_state` assembles the slices of the models,
the optimizers' moments and the EMA, a collective of every rank), and a
resume cuts them to each rank's slices again (:func:`load_run_state`), as
the JAX loops re-place a restored state.
"""
from __future__ import annotations

import copy
import os
import queue
import threading

import torch

from xgan_torch.io_.metrics import write_json
from xgan_torch.parallel import tp


class AsyncWriter:
    """One background IO thread with a bounded FIFO queue.

    ``submit(job)`` runs jobs strictly in submission order; ``flush()``
    waits for the queue to drain and re-raises the FIRST worker failure,
    as does the next ``submit``."""

    def __init__(self, maxsize: int = 8):
        self._maxsize = maxsize
        self._queue: queue.Queue | None = None  # started at first submit
        self._thread: threading.Thread | None = None
        self._error: BaseException | None = None

    def _drain(self) -> None:
        while True:
            job = self._queue.get()
            try:
                job()
            except BaseException as e:  # noqa: BLE001 — raised on flush()
                if self._error is None:
                    self._error = e
            finally:
                self._queue.task_done()

    def submit(self, job) -> None:
        # a failed write stops the run at the next save, not at the end
        if self._error is not None:
            err, self._error = self._error, None
            raise err
        if self._queue is None:
            # bounded: the loop blocks rather than pile up host copies
            self._queue = queue.Queue(maxsize=self._maxsize)
            self._thread = threading.Thread(target=self._drain,
                                            name="snapshot-writer",
                                            daemon=True)
            self._thread.start()
        self._queue.put(job)

    def flush(self, reraise: bool = True) -> None:
        """Wait for every queued write and re-raise the first worker
        failure. ``reraise=False`` is for exception paths: the queue still
        drains, and the failure is printed instead of masking the
        exception in flight."""
        if self._queue is not None:
            self._queue.join()
        if self._error is not None:
            err, self._error = self._error, None
            if reraise:
                raise err
            print(f"Warning: async checkpoint write failed: {err!r}")


def atomic_write(path: str, payload) -> None:
    """``torch.save`` via a temporary file and ``os.replace``."""
    tmp = f"{path}.tmp{os.getpid()}"
    torch.save(payload, tmp)
    os.replace(tmp, path)


def host_copy(tree):
    """A copy of a nested dict/list/tuple of tensors and plain values,
    with every tensor on the host, taken in stream order. Returns
    ``(copy, event)``: ``event`` is None when no tensor was on CUDA, else
    the CUDA event after which the copy's bytes are complete."""
    on_cuda = []

    def leaf(x):
        if isinstance(x, torch.Tensor):
            x = x.detach()
            if x.is_cuda:
                on_cuda.append(True)
                out = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
                return out.copy_(x, non_blocking=True)
            return x.clone()
        if isinstance(x, dict):
            return {k: leaf(v) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return type(x)(leaf(v) for v in x)
        return copy.deepcopy(x)

    out = leaf(tree)
    event = None
    if on_cuda:
        event = torch.cuda.Event()
        event.record()
    return out, event


def _tensor_shapes(tree, prefix=""):
    """{dotted path: shape} of every tensor in a nested dict."""
    if isinstance(tree, torch.Tensor):
        yield prefix, tuple(tree.shape)
    elif isinstance(tree, dict):
        for k, v in tree.items():
            yield from _tensor_shapes(v, f"{prefix}.{k}" if prefix else
                                      str(k))


class SnapshotManager:
    def __init__(self, path: str, async_io: bool = False):
        self.path = path
        self.async_io = async_io
        self._writer = AsyncWriter()

    def _write(self, path: str, tree) -> None:
        payload, event = host_copy(tree)
        if not self.async_io:
            if event is not None:
                event.synchronize()
            atomic_write(path, payload)
            return

        def job():
            if event is not None:
                event.synchronize()
            atomic_write(path, payload)
        self._writer.submit(job)

    def save(self, states: dict, epoch: int, iters: int) -> None:
        """Snapshot ``states`` (see :func:`run_state`) with the counters."""
        self._write(self.path, {**states, "epoch": epoch, "iters": iters})

    def save_file(self, path: str, tree) -> None:
        """Save any state dict (epoch checkpoints ride the same writer as
        the snapshot when async)."""
        self._write(path, tree)

    def save_json(self, path: str, obj) -> None:
        """A JSON artifact through the same FIFO, so it lands after the
        snapshot queued before it. ``obj`` is copied now: the caller
        keeps mutating it."""
        snap = copy.deepcopy(obj)
        if not self.async_io:
            write_json(path, snap)
            return
        self._writer.submit(lambda: write_json(path, snap))

    def flush(self, reraise: bool = True) -> None:
        """Wait for every queued write; see :meth:`AsyncWriter.flush`.
        Every loop exit path calls it: the writer is a daemon thread."""
        self._writer.flush(reraise)

    def try_resume(self, resume_from: str, template: dict):
        """Returns ``(snapshot or None, epoch, iters)``. ``resume_from``:
        a path, ``auto`` (this run's own snapshot if it exists) or ``""``.

        ``template``: the current run's :func:`run_state`. The snapshot
        must carry exactly its keys (with the JAX package's hints when
        ``ema`` is extra or missing) and the same tensor shapes."""
        if resume_from == "auto":
            resume_from = self.path if os.path.exists(self.path) else ""
        if not resume_from:
            return None, 0, 0
        if not os.path.exists(resume_from):
            # an explicit path that does not exist is a user error:
            # starting fresh would discard the run asked to continue
            raise FileNotFoundError(
                f"snapshot {resume_from} not found (use --resume-from auto "
                "to start fresh when no snapshot exists)")
        snap = torch.load(resume_from, map_location="cpu", weights_only=True)
        like = set(template) | {"epoch", "iters"}
        extra = sorted(set(snap) - like)
        if extra:
            hint = (" — re-add --ema-decay to resume it (resuming "
                    "without the flag would silently discard the "
                    "accumulated EMA at the next snapshot save)"
                    if "ema" in extra else "")
            raise ValueError(
                f"snapshot {resume_from} carries state the current "
                f"flags do not use: {', '.join(extra)}{hint}")
        missing = sorted(like - set(snap))
        if missing:
            hint = (" (the snapshot predates --ema-decay; resume "
                    "without the flag or start fresh)"
                    if "ema" in missing else "")
            raise ValueError(f"cannot load snapshot {resume_from}: it lacks "
                             f"{', '.join(missing)}{hint}")
        got = dict(_tensor_shapes(snap))
        for name, shape in _tensor_shapes(template):
            if got.get(name) != shape:
                raise ValueError(
                    f"snapshot {resume_from} does not match the current "
                    f"model flags: {name} has shape {got.get(name)}, the "
                    f"model needs {shape}")
        epoch, iters = int(snap["epoch"]), int(snap["iters"])
        print(f"Resumed from {resume_from} at epoch {epoch}, iter {iters}")
        return snap, epoch, iters


def run_state(models: dict, opts: dict, ema, rng: torch.Generator) -> dict:
    """What a snapshot holds, as live references (no copy) where nothing
    is assembled: each model's state dict under its name (``g``, ``d`` or
    ``c``), each optimizer's under ``opt_<name>``, the EMA tensors
    (``ema``, when on, of the first model's parameters) and the step-draw
    generator's state (``rng``). Every tensor is whole: under tensor
    parallelism or ZeRO-1 a collective of every rank assembles it."""
    out = {name: tp.whole_state_dict(m) for name, m in models.items()}
    out.update({f"opt_{name}": tp.whole_opt_state_dict(o)
                for name, o in opts.items()})
    if ema is not None:
        out["ema"] = tp.whole_state_dict(next(iter(models.values())), ema)
    out["rng"] = rng.get_state()
    return out


def resume_run(mgr: SnapshotManager, resume_from: str, models: dict,
               opts: dict, ema, rng: torch.Generator) -> tuple[int, int]:
    """``mgr.try_resume`` against this run's state, restored in place
    when a snapshot is found; returns ``(start epoch, iters)``. Raises
    as ``try_resume`` does."""
    snap, epoch, iters = mgr.try_resume(resume_from,
                                        run_state(models, opts, ema, rng))
    if snap is not None:
        load_run_state(snap, models, opts, ema, rng)
    return epoch, iters


def save_epoch(mgr: SnapshotManager, model_dir: str, epoch: int,
               iters: int, models: dict, history_path: str,
               history: dict, states: dict) -> None:
    """An epoch boundary's writes, in the writer's order: G's and D's (or
    the critic's) ``{generator,discriminator}_epoch_EEE.pth``, the
    snapshot, then the history, which so never lands before its
    snapshot. ``epoch``: the number of epochs done; ``states``: the
    run's :func:`run_state`, which every rank assembles (the models'
    whole state dicts among it)."""
    tag = f"epoch_{epoch:03d}"
    g, second = models
    mgr.save_file(os.path.join(model_dir, f"generator_{tag}.pth"),
                  states[g])
    mgr.save_file(os.path.join(model_dir, f"discriminator_{tag}.pth"),
                  states[second])
    mgr.save(states, epoch, iters)
    mgr.save_json(history_path, history)
    print(f"Saved checkpoints for epoch {epoch} to {model_dir}")


def load_run_state(snap: dict, models: dict, opts: dict, ema,
                   rng: torch.Generator) -> None:
    """Restore a :func:`run_state` snapshot in place (tensors keep their
    storage, which a captured CUDA graph relies on), each whole tensor
    cut to this rank's slice under tensor parallelism."""
    for name, m in models.items():
        tp.load_whole(m, snap[name], strict=True)
    for name, o in opts.items():
        load_optimizer(o, tp.opt_state_for_load(o, snap[f"opt_{name}"]))
    if ema is not None:
        first = next(iter(models.values()))
        with torch.no_grad():
            for k, v in tp.slice_state(first, snap["ema"]).items():
                ema[k].copy_(v)
    rng.set_state(snap["rng"])


def load_optimizer(opt: torch.optim.Optimizer, sd: dict) -> None:
    """``opt.load_state_dict(sd)`` that keeps ``opt``'s own ``capturable``
    flag: the DCGAN trainer's Adam is capturable on the card only, so a
    snapshot taken on the card resumes with ``--cpu`` and back. A
    capturable Adam keeps ``step`` on the parameter's device, the other on
    the host, as each would have made it."""
    groups = [dict(saved, capturable=cur.get("capturable", False))
              for saved, cur in zip(sd["param_groups"], opt.param_groups)]
    opt.load_state_dict({"state": sd["state"], "param_groups": groups})
    for group in opt.param_groups:
        if group.get("capturable", False):
            continue
        for p in group["params"]:
            st = opt.state.get(p)
            if st and torch.is_tensor(st.get("step")):
                st["step"] = st["step"].to("cpu", torch.float32)
