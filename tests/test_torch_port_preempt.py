"""Preemption and resume in xgan_torch's three GAN loops, against the JAX
package's contract (tests/test_preempt.py, tests/test_ema.py).

``GracefulShutdown``: the first signal sets the flag, the second raises
KeyboardInterrupt, it is inert off the main thread and ``restore`` puts
back the previous handler. ``checkpoint_boundary`` reads the flag once.
A real SIGTERM to ``python -m xgan_torch.cli.train_gan --cpu`` after its
second epoch ends the run with exit 0, the preempt notice and
``snapshot_last.pth``; ``--resume-from auto`` completes the epochs with a
merged history. A run straight through and one stopped and resumed end
with the same final state dicts (the EMA's too) and the same history in
the DCGAN, WGAN-GP and CGAN loops; the CGAN's resume crosses epoch 5,
where its adaptive gate starts to read D's outputs."""
import json
import os
import signal
import subprocess
import sys
import threading

import pytest
import torch

from xgan.train.loop_common import GracefulShutdown as JaxShutdown
from xgan_torch.cli import train_cgan, train_gan, train_wggan
from xgan_torch.train.loop_common import GracefulShutdown, \
    checkpoint_boundary

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("cls", [GracefulShutdown, JaxShutdown],
                         ids=["port", "jax"])
def test_graceful_shutdown_unit(cls):
    prev = signal.getsignal(signal.SIGTERM)
    sd = cls()
    sd.install()
    try:
        os.kill(os.getpid(), signal.SIGTERM)
        assert sd.requested
        with pytest.raises(KeyboardInterrupt):
            os.kill(os.getpid(), signal.SIGTERM)
    finally:
        sd.restore()
    assert signal.getsignal(signal.SIGTERM) is prev
    seen = []

    def worker():
        sd2 = cls()
        sd2.install()  # signal.signal raises off the main thread
        seen.append(sd2.requested)
        sd2.restore()

    t = threading.Thread(target=worker)
    t.start()
    t.join(timeout=10)
    assert not t.is_alive() and seen == [False]
    assert signal.getsignal(signal.SIGTERM) is prev


def test_checkpoint_boundary_latches_once():
    class FlipFlop:
        def __init__(self):
            self.reads = 0

        @property
        def requested(self):
            self.reads += 1
            return self.reads > 1

    saved = []
    ff = FlipFlop()
    stop = checkpoint_boundary(ff, epoch=0, epochs=10, interval=10,
                               save=lambda: saved.append(1))
    assert ff.reads == 1
    assert not stop and not saved

    class Always:
        requested = True

    stop = checkpoint_boundary(Always(), epoch=0, epochs=10, interval=10,
                               save=lambda: saved.append(2))
    assert stop and saved == [2]
    stop = checkpoint_boundary(Always(), epoch=9, epochs=10, interval=10,
                               save=lambda: saved.append(3))
    assert not stop and saved == [2, 3]


def test_sigterm_checkpoints_and_resume_completes(fake_dataset, tmp_path):
    out = tmp_path / "run"
    epochs = 40
    args = [sys.executable, "-u", "-m", "xgan_torch.cli.train_gan", "--cpu",
            "--data-dir", fake_dataset["data_dir"],
            "--model-dir", str(out / "models"),
            "--output-dir", str(out / "results"),
            "--results-dir", str(out / "results/metrics"),
            "--figures-dir", str(out / "results/figures"),
            "--cache-dir", str(out / "cache"),
            "--image-size", "32", "--feature-maps-g", "8",
            "--feature-maps-d", "8", "--latent-dim", "16",
            "--epochs", str(epochs), "--batch-size", "8",
            "--vis-batch-size", "8", "--save-interval", "1000"]
    env = {**os.environ, "OMP_NUM_THREADS": "1"}
    p = subprocess.Popen(args, stdout=subprocess.PIPE,
                         stderr=subprocess.STDOUT, text=True, cwd=ROOT,
                         env=env)
    sent, lines = False, []
    watchdog = threading.Timer(300, p.kill)  # a hung child fails the test
    watchdog.start()
    try:
        for ln in p.stdout:
            lines.append(ln)
            if not sent and f"Epoch 2/{epochs} Summary" in ln:
                p.send_signal(signal.SIGTERM)
                sent = True
        rc = p.wait(timeout=300)
    finally:
        watchdog.cancel()
        if p.poll() is None:
            p.kill()
            p.wait()
    text = "".join(lines)
    assert sent, text
    assert rc == 0, text
    assert "Received signal" in text and "Preempted" in text, text
    assert (out / "models/gan/snapshot_last.pth").exists(), text
    assert not (out / "models/gan/generator_final.pth").exists()
    hist_path = out / "results/metrics/gan_training_history.json"
    stopped = len(json.loads(hist_path.read_text())["G_losses_epoch"])
    # the default --checkpoint-interval is 10: the save was forced
    assert 2 <= stopped < epochs, stopped
    assert f"Preempted: training stopped after epoch {stopped} " in text

    done = subprocess.run(args + ["--resume-from", "auto"],
                          capture_output=True, text=True, timeout=600,
                          cwd=ROOT, env=env)
    assert done.returncode == 0, done.stdout + done.stderr
    assert f"at epoch {stopped}, iter {3 * stopped}" in done.stdout
    hist = json.loads(hist_path.read_text())
    assert len(hist["G_losses_epoch"]) == epochs
    assert len(hist["G_losses_iter"]) == 3 * epochs
    assert (out / "models/gan/generator_final.pth").exists()


# (CLI module, model subdirectory, epochs, epochs of the first leg, flags)
LOOPS = {
    "dcgan": (train_gan, "gan", 3, 1, ["--batch-size", "16"]),
    "wgan": (train_wggan, "wgan", 3, 1, ["--batch-size", "16",
                                         "--critic-iters", "2"]),
    "cgan": (train_cgan, "cgan", 7, 4, ["--batch-size", "8",
                                        "--limit-batches", "1"]),
}


@pytest.mark.parametrize("loop", sorted(LOOPS))
def test_straight_and_resumed_runs_end_equal(fake_dataset, tmp_path, loop):
    cli, sub, epochs, first, flags = LOOPS[loop]

    def run(name, n, *extra):
        out = tmp_path / name
        return cli.main([
            "--cpu", "--data-dir", fake_dataset["data_dir"],
            "--model-dir", str(out / "models"),
            "--output-dir", str(out / "results"),
            "--results-dir", str(out / "metrics"),
            "--figures-dir", str(out / "figures"),
            "--cache-dir", str(tmp_path / "cache"), "--image-size", "32",
            "--feature-maps-g", "8", "--feature-maps-d", "8",
            "--latent-dim", "16", "--vis-batch-size", "8",
            "--checkpoint-interval", "1", "--ema-decay", "0.9",
            "--epochs", str(n), *flags, *extra])

    straight = run("straight", epochs)
    run("resumed", first)
    resumed = run("resumed", epochs, "--resume-from", "auto")
    assert resumed == straight
    for name in ("generator_final.pth", "discriminator_final.pth",
                 "generator_ema_final.pth"):
        a = torch.load(tmp_path / "straight/models" / sub / name,
                       weights_only=True)
        b = torch.load(tmp_path / "resumed/models" / sub / name,
                       weights_only=True)
        assert set(a) == set(b)
        for k in a:
            torch.testing.assert_close(b[k], a[k], rtol=0, atol=0,
                                       msg=f"{name} {k}")
