"""xgan_torch's SnapshotManager (``xgan_torch/train/snapshot.py``) against
the JAX package's: the same resume semantics and the same messages on the
same cases, over the port's own file (``torch.save`` of the run state: G
and D state dicts, both optimizers, the EMA, the step-draw generator).

A save/resume round trip restores every tensor, the optimizer state and
the generator's stream; ``auto`` without a snapshot starts fresh and an
explicit missing path fails with the JAX message; async bytes equal sync
bytes; the FIFO lands saves in order, the last one wins, and state
mutated after ``save`` does not leak into the file; a worker failure
re-raises on ``flush`` and on the next ``save``; an extra or missing
``ema`` fails with the JAX hints; a shape mismatch is refused; a
snapshot of the card's capturable Adam resumes into the CPU's Adam."""
import json

import jax.numpy as jnp
import pytest
import torch

from xgan.train.common import ModelState
from xgan.train.common import adam as jax_adam
from xgan.train.snapshot import SnapshotManager as JaxSnapshotManager
from xgan_torch.models.dcgan import Discriminator, Generator
from xgan_torch.train.common import adam
from xgan_torch.train.ema import init_ema
from xgan_torch.train.snapshot import (SnapshotManager, load_run_state,
                                       run_state)

torch.set_num_threads(1)

LATENT, FM, SIZE = 8, 8, 32


def _run(seed, ema=False, fm=FM):
    """(models, opts, ema, rng) of a tiny DCGAN after one optimizer step,
    so that Adam has state."""
    g = Generator(LATENT, 3, fm, SIZE,
                  generator=torch.Generator().manual_seed(seed))
    d = Discriminator(3, fm, SIZE,
                      generator=torch.Generator().manual_seed(seed + 1))
    opts = {"g": adam(g.parameters(), 2e-4, 0.5),
            "d": adam(d.parameters(), 2e-4, 0.5)}
    for name, m in (("g", g), ("d", d)):
        for p in m.parameters():
            p.grad = torch.full_like(p, 0.1 * (seed + 1))
        opts[name].step()
    rng = torch.Generator().manual_seed(seed + 2)
    torch.randn(3, generator=rng)  # advance the stream
    return {"g": g, "d": d}, opts, (init_ema(g) if ema else None), rng


def _jax_state(value):
    params = {"w": jnp.full((3, 3), value)}
    return ModelState(params=params, batch_stats={},
                      opt_state=jax_adam(1e-3, 0.9).init(params))


def test_save_resume_roundtrip(tmp_path):
    path = str(tmp_path / "snapshot_last.pth")
    models, opts, ema, rng = _run(1, ema=True)
    with torch.no_grad():
        for v in ema.values():
            v.mul_(0.5)
    SnapshotManager(path).save(run_state(models, opts, ema, rng), epoch=7,
                               iters=123)
    want_draws = torch.randn(5, generator=rng)

    fresh = _run(5, ema=True)
    snap, epoch, iters = SnapshotManager(path).try_resume(
        "auto", run_state(*fresh))
    assert (epoch, iters) == (7, 123)
    load_run_state(snap, *fresh)
    f_models, f_opts, f_ema, f_rng = fresh
    for name in ("g", "d"):
        for k, v in models[name].state_dict().items():
            torch.testing.assert_close(f_models[name].state_dict()[k], v,
                                       rtol=0, atol=0)
        sa, sb = opts[name].state_dict(), f_opts[name].state_dict()
        assert sa["param_groups"] == sb["param_groups"]
        for i, st in sa["state"].items():
            for k, v in st.items():
                torch.testing.assert_close(sb["state"][i][k], v, rtol=0,
                                           atol=0)
    for k, v in ema.items():
        torch.testing.assert_close(f_ema[k], v, rtol=0, atol=0)
    torch.testing.assert_close(torch.randn(5, generator=f_rng), want_draws,
                               rtol=0, atol=0)


def test_resume_missing_starts_fresh(tmp_path):
    """``auto`` without a snapshot starts fresh; an explicit missing path
    fails with the JAX package's message."""
    state = run_state(*_run(0))
    mgr = SnapshotManager(str(tmp_path / "none.pth"))
    assert mgr.try_resume("auto", state) == (None, 0, 0)
    assert mgr.try_resume("", state) == (None, 0, 0)
    gone = str(tmp_path / "gone.pth")
    with pytest.raises(FileNotFoundError) as ours:
        mgr.try_resume(gone, state)
    with pytest.raises(FileNotFoundError) as theirs:
        JaxSnapshotManager(str(tmp_path / "none.msgpack")).try_resume(
            gone, {"g": _jax_state(0.0)})
    assert str(ours.value) == str(theirs.value)


def test_async_save_matches_sync_bytes(tmp_path):
    """(In two directories under one name: ``torch.save`` writes the
    file's name into the archive.)"""
    state = run_state(*_run(1, ema=True))
    for sub in ("sync", "async"):
        (tmp_path / sub).mkdir()
    sync_path = str(tmp_path / "sync" / "snapshot_last.pth")
    SnapshotManager(sync_path).save(state, epoch=7, iters=123)
    async_path = str(tmp_path / "async" / "snapshot_last.pth")
    mgr = SnapshotManager(async_path, async_io=True)
    mgr.save(state, epoch=7, iters=123)
    mgr.flush()
    assert open(async_path, "rb").read() == open(sync_path, "rb").read()
    _, epoch, iters = mgr.try_resume("auto", run_state(*_run(2, ema=True)))
    assert (epoch, iters) == (7, 123)


def test_async_fifo_last_save_wins_and_state_mutation_safe(tmp_path):
    """Saves land in submission order; each holds the state of its call:
    parameters updated in place after ``save`` and a history mutated after
    ``save_json`` do not leak into the files."""
    path = str(tmp_path / "snapshot_last.pth")
    mgr = SnapshotManager(path, async_io=True)
    models, opts, ema, rng = _run(1)
    w = models["g"].main[0].weight
    w_at_save = w.detach().clone()
    mgr.save(run_state(models, opts, ema, rng), epoch=1, iters=10)
    mgr.save_file(str(tmp_path / "generator_epoch_001.pth"),
                  models["g"].state_dict())
    with torch.no_grad():
        w.add_(1.0)  # an optimizer step after the boundary
    mgr.save(run_state(models, opts, ema, rng), epoch=2, iters=20)
    history = {"loss": [1.0]}
    mgr.save_json(str(tmp_path / "hist.json"), history)
    history["loss"].append(2.0)
    mgr.flush()

    snap, epoch, iters = mgr.try_resume("auto", run_state(*_run(3)))
    assert (epoch, iters) == (2, 20)
    torch.testing.assert_close(snap["g"]["main.0.weight"], w_at_save + 1.0,
                               rtol=0, atol=0)
    ckpt = torch.load(tmp_path / "generator_epoch_001.pth",
                      weights_only=True)
    torch.testing.assert_close(ckpt["main.0.weight"], w_at_save, rtol=0,
                               atol=0)
    assert json.load(open(tmp_path / "hist.json")) == {"loss": [1.0]}


def test_async_write_failure_raises_on_flush_and_next_save(tmp_path):
    """A failed background write re-raises on ``flush`` (then the error is
    consumed) and, when the loop saves again first, on that ``save``."""
    state = run_state(*_run(0))
    (tmp_path / "snap.pth").mkdir()  # the rename onto a directory fails
    mgr = SnapshotManager(str(tmp_path / "snap.pth"), async_io=True)
    mgr.save(state, epoch=1, iters=1)
    with pytest.raises(OSError):
        mgr.flush()
    mgr.flush()

    mgr.save(state, epoch=1, iters=1)
    mgr._writer._queue.join()  # let the worker hit the failure
    with pytest.raises(OSError):
        mgr.save(state, epoch=2, iters=2)
    mgr.flush()


@pytest.mark.parametrize("saved_ema,resume_ema", [(False, True),
                                                  (True, False)])
def test_ema_key_mismatch_fails_with_the_jax_hint(tmp_path, saved_ema,
                                                  resume_ema):
    """A snapshot without ``ema`` resumed with ``--ema-decay`` (and the
    reverse) fails with the hint the JAX package gives for the case."""
    path = str(tmp_path / "snapshot_last.pth")
    SnapshotManager(path).save(run_state(*_run(0, ema=saved_ema)), epoch=3,
                               iters=30)
    with pytest.raises(ValueError) as ours:
        SnapshotManager(path).try_resume(
            path, run_state(*_run(1, ema=resume_ema)))

    jax_path = str(tmp_path / "snapshot_last.msgpack")
    jmgr = JaxSnapshotManager(jax_path)
    ema = {"ema": {"w": jnp.zeros((3, 3))}}
    jmgr.save({"g": _jax_state(1.0), **(ema if saved_ema else {})},
              epoch=3, iters=30)
    with pytest.raises(ValueError) as theirs:
        jmgr.try_resume(jax_path, {"g": _jax_state(0.0),
                                   **(ema if resume_ema else {})})
    hint = ("predates --ema-decay" if resume_ema
            else "re-add --ema-decay to resume it")
    assert hint in str(ours.value) and hint in str(theirs.value)


def test_shape_mismatch_is_refused(tmp_path):
    """A snapshot of other model widths does not resume."""
    path = str(tmp_path / "snapshot_last.pth")
    SnapshotManager(path).save(run_state(*_run(0)), epoch=1, iters=2)
    with pytest.raises(ValueError, match="does not match the current "
                                         "model flags"):
        SnapshotManager(path).try_resume(path,
                                         run_state(*_run(1, fm=2 * FM)))


def test_card_snapshot_resumes_into_the_cpu_adam(tmp_path):
    """The DCGAN trainer's Adam is capturable on the card only. A snapshot
    whose optimizer groups say ``capturable`` (as one taken on the card
    does) resumes into the CPU's Adam: the flag stays off, ``step`` stays
    on the host, and the next update equals that of the run it came
    from."""
    models, opts, ema, rng = _run(1)
    path = str(tmp_path / "snapshot_last.pth")
    state = run_state(models, opts, ema, rng)
    for name in ("g", "d"):
        for group in state[f"opt_{name}"]["param_groups"]:
            group["capturable"] = True
    SnapshotManager(path).save(state, epoch=1, iters=1)
    fresh = _run(4)
    snap, _, _ = SnapshotManager(path).try_resume("auto", run_state(*fresh))
    load_run_state(snap, *fresh)
    for name in ("g", "d"):
        assert not any(g["capturable"]
                       for g in fresh[1][name].param_groups)
        for st in fresh[1][name].state.values():
            assert st["step"].device.type == "cpu"
        for o, m in ((opts[name], models[name]),
                     (fresh[1][name], fresh[0][name])):
            for p in m.parameters():
                p.grad = torch.full_like(p, 0.3)
            o.step()
        for (k, a), b in zip(models[name].state_dict().items(),
                             fresh[0][name].state_dict().values()):
            torch.testing.assert_close(b, a, rtol=0, atol=0, msg=k)
