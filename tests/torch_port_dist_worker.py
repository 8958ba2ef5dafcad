"""One rank of the xgan_torch data-parallel checks (imports no jax), and
the launchers the ``tests/test_torch_port_dist_*.py`` files start ranks
with.

    RANK=r WORLD_SIZE=n LOCAL_RANK=r MASTER_ADDR=127.0.0.1 MASTER_PORT=p \\
        python tests/torch_port_dist_worker.py IN.pt OUT_DIR

joins the gloo group through ``init_from_env(cpu=True)``, runs every case
named in ``IN.pt`` (a ``torch.save``d dict: case name -> its inputs) on
its rows, and writes ``OUT_DIR/rank{r}.pt``: case name -> its outputs.
"""
import os
import socket
import subprocess
import sys
import types

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RANK_TIMEOUT = 120  # s: a stuck rendezvous fails the test instead


def _store(images, labels=None):
    images = np.asarray(images)
    if labels is None:
        labels = np.zeros(images.shape[0], np.int32)
    return types.SimpleNamespace(images=images,
                                 labels=np.asarray(labels, np.int32))


def case_gan(inp, mesh):
    """DCGAN steps of one rank: each run of ``inp["runs"]`` (name ->
    shard) from the same weights over the same steps; per run the (steps,
    5) metrics and G's and D's state dicts."""
    from xgan_torch.data.pipeline import DeviceStore
    from xgan_torch.models.dcgan import Discriminator, Generator
    from xgan_torch.models.layers import sync_batch_norm
    from xgan_torch.train.common import adam
    from xgan_torch.train.gan import dcgan_step
    latent, fm, size, lr = inp["latent"], inp["fm"], inp["size"], inp["lr"]
    out = {}
    for name, shard in inp["runs"].items():
        g, d = Generator(latent, 3, fm, size), Discriminator(3, fm, size)
        g.load_state_dict(inp["g"])
        d.load_state_dict(inp["d"])
        sync_batch_norm(g, mesh)
        sync_batch_norm(d, mesh)
        opt_g = adam(g.parameters(), lr, 0.5)
        opt_d = adam(d.parameters(), lr, 0.5)
        store = DeviceStore(_store(inp["images"]), "cpu", mesh, shard=shard)
        metrics = [dcgan_step(g, d, opt_g, opt_d, store.images, s["idx"],
                              latent_dim=latent, mask=s["mask"],
                              noise=s["noise"], flip=s["flip"],
                              take=store.take, mesh=mesh)
                   for s in inp["steps"]]
        out[name] = {"metrics": torch.stack(metrics),
                     "g": g.state_dict(), "d": d.state_dict(),
                     "local_rows": store.images.shape[0]}
    return out


def case_bn(inp, mesh):
    """Train-mode BN of this rank's rows through ``layers.batch_norm`` of
    a BN tied to ``mesh``, for each mask of ``inp["masks"]``: the output
    rows, their input gradient, this rank's part of the scale and bias
    gradients, and the new running statistics."""
    from torch import nn

    from xgan_torch.models.layers import batch_norm, sync_batch_norm
    x, ct = inp["x"], inp["ct"]
    rows = mesh.local_rows(x.shape[0])
    out = {}
    for name, mask in inp["masks"].items():
        bn = nn.BatchNorm2d(x.shape[-1])
        bn.load_state_dict(inp["bn"])
        sync_batch_norm(bn, mesh)
        xr = x[rows].clone().requires_grad_(True)
        y = batch_norm(bn, xr, train=True, dim=-1,
                       mask=None if mask is None else mask[rows])
        (y * ct[rows]).sum().backward()
        out[name] = {"y": y.detach(), "dx": xr.grad,
                     "dscale": bn.weight.grad, "dbias": bn.bias.grad,
                     "mean": bn.running_mean.clone(),
                     "var": bn.running_var.clone()}
    return out


def case_classifier(inp, mesh):
    """One classifier step (``--unfreeze``) of this rank for each run of
    ``inp["runs"]`` (name -> (mode, shard, masked)): the global
    per-sample (losses, preds, labels), the rank's u8 rows of the batch,
    and the model's state dict."""
    from xgan_torch.data.pipeline import DeviceStore
    from xgan_torch.models.resnet import ResNet50
    from xgan_torch.models.layers import sync_batch_norm
    from xgan_torch.train.classifier import assemble, classifier_optimizer, \
        train_step
    out = {}
    b = inp["idx"].shape[0]
    for name, (mode, shard, masked) in inp["runs"].items():
        real = DeviceStore(_store(inp["real"], inp["real_labels"]), "cpu",
                           mesh, shard=shard)
        synth = DeviceStore(_store(inp["synth"], inp["synth_labels"]), "cpu")
        model = ResNet50(2, stage_sizes=inp["stages"])
        model.load_state_dict(inp["model"])
        sync_batch_norm(model, mesh)
        opt = classifier_optimizer(model, inp["lr"], freeze_base=False)
        rows_u8, _ = assemble(mode, real, synth, inp["idx"],
                              ratio=inp["ratio"], use_synth=inp["use_synth"],
                              synth_pick=inp["pick"],
                              rows=mesh.local_rows(b))
        losses, preds, labels = train_step(
            model, opt, real, synth, inp["idx"], mode=mode,
            ratio=inp["ratio"], mask=inp["mask"] if masked else None,
            flip=inp["flip"],
            use_synth=inp["use_synth"], synth_pick=inp["pick"], mesh=mesh)
        out[name] = {"losses": losses, "preds": preds, "labels": labels,
                     "rows_u8": rows_u8, "model": model.state_dict()}
    return out


def case_take(inp, mesh):
    """For each store of ``inp`` (name -> (images, idx)): its sharded
    ``take`` of ``idx`` on this rank, whole and this rank's rows, with
    the store's logical length and the rows this rank holds."""
    from xgan_torch.data.pipeline import DeviceStore
    out = {}
    for name, (images, idx) in inp.items():
        store = DeviceStore(_store(images), "cpu", mesh, shard=True)
        out[name] = {"rows": store.take(store.images, idx),
                     "mine": store.take(store.images, idx,
                                        mesh.local_rows(idx.shape[0])),
                     "len": len(store), "held": store.images.shape[0],
                     "sharded": store.sharded}
    return out


CASES = {"gan": case_gan, "bn": case_bn, "classifier": case_classifier,
         "take": case_take}


def main(in_path: str, out_dir: str) -> None:
    sys.path.insert(0, ROOT)
    torch.set_num_threads(1)
    from xgan_torch.parallel.mesh import init_from_env, shutdown
    mesh = init_from_env(cpu=True)
    try:
        inputs = torch.load(in_path, weights_only=True)
        out = {case: CASES[case](inp, mesh) for case, inp in inputs.items()}
        torch.save(out, os.path.join(out_dir, f"rank{mesh.rank}.pt"))
    finally:
        shutdown(mesh)


# ---- the launchers (run in the test process) ----

def free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def rank_env(rank: int, world: int, port: int) -> dict:
    """The environment ``torchrun`` gives rank ``rank`` of ``world`` on
    one host."""
    return {**os.environ, "RANK": str(rank), "WORLD_SIZE": str(world),
            "LOCAL_RANK": str(rank), "MASTER_ADDR": "127.0.0.1",
            "MASTER_PORT": str(port), "OMP_NUM_THREADS": "1"}


def start_ranks(argv: list, world: int, logs: list | None = None) -> list:
    """``world`` processes of ``argv``, each with its rank's environment
    (a free port for the group), stdout and stderr merged into a pipe or
    into ``logs[rank]``, an open file."""
    port = free_port()
    return [subprocess.Popen(argv, env=rank_env(r, world, port), cwd=ROOT,
                             stdout=subprocess.PIPE if logs is None
                             else logs[r],
                             stderr=subprocess.STDOUT, text=True)
            for r in range(world)]


def wait_ranks(procs: list, timeout: float = RANK_TIMEOUT) -> list:
    """Each rank's (exit code, output); a rank still running after
    ``timeout`` seconds is killed, and so are the others."""
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=timeout)
            outs.append((p.returncode, out))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return outs


def run_cases(inputs: dict, tmp, world: int = 2) -> dict:
    """Run the cases of ``inputs`` on ``world`` gloo ranks; returns case
    name -> [each rank's outputs]."""
    tmp = str(tmp)
    in_path = os.path.join(tmp, "in.pt")
    torch.save(inputs, in_path)
    outs = wait_ranks(start_ranks(
        [sys.executable, os.path.abspath(__file__), in_path, tmp], world))
    for rc, text in outs:
        assert rc == 0, text[-4000:]
    ranks = [torch.load(os.path.join(tmp, f"rank{r}.pt"), weights_only=True)
             for r in range(world)]
    return {case: [r[case] for r in ranks] for case in inputs}


if __name__ == "__main__":
    main(*sys.argv[1:3])
