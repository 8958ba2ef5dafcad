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


def penalty(x, w, v, n: int, reduce_sum):
    """``sum_i (||d s/d x_i|| - 1)^2 / n`` over the rows ``x`` (float64)
    of a batch of ``n``, where ``s`` sums the scores ``tanh(bn(x @ w)) @ v``
    and ``bn`` normalizes each column by the batch's mean and variance,
    their sums taken by ``reduce_sum`` (identity on one process, the
    cross-rank ``all_reduce_sum`` on a rank). The input gradient keeps
    its graph, so the result is differentiable in ``w``: the double
    backward of WGAN-GP's penalty through cross-rank BN."""
    x = x.clone().requires_grad_(True)
    h = x @ w
    sums = reduce_sum(torch.stack([h.sum(0), h.square().sum(0)]))
    mean = sums[0] / n
    var = sums[1] / n - mean.square()
    scores = torch.tanh((h - mean) / torch.sqrt(var + 1e-5)) @ v
    grads, = torch.autograd.grad(scores.sum(), x, create_graph=True)
    return (grads.norm(dim=1) - 1.0).square().sum() / n


def cue_probe_class():
    """The CGAN discriminator plus an input-magnitude cue on its logits
    (the closed-gate probe of tests/test_cgan.py:78-106): constant-255
    reals normalize to ~|2.2| while tanh fakes stay within 1, so
    ``20 mean(relu(|x| - 1.5)) - 5`` makes D(x) ~ 1 and D(G(z)) < 0.1."""
    from xgan_torch.models.cgan import Discriminator

    class CueProbe(Discriminator):
        def forward(self, x, labels, *, train, features=False, mask=None):
            out = super().forward(x, labels, train=train,
                                  features=features, mask=mask)
            cue = 20.0 * torch.relu(x.float().abs() - 1.5).mean(
                dim=(1, 2, 3)) - 5.0
            return (out[0] + cue, out[1]) if features else out + cue

    return CueProbe


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
                              take=store.take, mesh=mesh,
                              grad_accum=s.get("grad_accum", 1))
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
    ``inp["runs"]`` (name -> (mode, shard, masked), or (mode, shard,
    masked, grad_accum, remat scope or None)): the global per-sample
    (losses, preds, labels), the rank's u8 rows of the batch, the model's
    state dict and the step's ``mixed_gather`` calls."""
    from xgan_torch.kernels import gather as gather_mod
    from xgan_torch.data.pipeline import DeviceStore
    from xgan_torch.models.resnet import ResNet50
    from xgan_torch.models.layers import sync_batch_norm
    from xgan_torch.train.classifier import assemble, classifier_optimizer, \
        train_step
    out = {}
    b = inp["idx"].shape[0]
    for name, run in inp["runs"].items():
        mode, shard, masked, accum, remat = (*run, 1, None)[:5]
        real = DeviceStore(_store(inp["real"], inp["real_labels"]), "cpu",
                           mesh, shard=shard)
        synth = DeviceStore(_store(inp["synth"], inp["synth_labels"]), "cpu")
        model = ResNet50(2, stage_sizes=inp["stages"], remat=bool(remat),
                         remat_scope=remat or "block")
        model.load_state_dict(inp["model"])
        sync_batch_norm(model, mesh)
        opt = classifier_optimizer(model, inp["lr"], freeze_base=False)
        rows_u8, _ = assemble(mode, real, synth, inp["idx"],
                              ratio=inp["ratio"], use_synth=inp["use_synth"],
                              synth_pick=inp["pick"],
                              rows=mesh.local_rows(b))
        calls = [0]
        ref = gather_mod.mixed_gather_ref  # the CPU tensors' gather

        def counted(*args, **kwargs):
            calls[0] += 1
            return ref(*args, **kwargs)

        gather_mod.mixed_gather_ref = counted
        try:
            losses, preds, labels = train_step(
                model, opt, real, synth, inp["idx"], mode=mode,
                ratio=inp["ratio"], mask=inp["mask"] if masked else None,
                flip=inp["flip"], use_synth=inp["use_synth"],
                synth_pick=inp["pick"], grad_accum=accum, mesh=mesh)
        finally:
            gather_mod.mixed_gather_ref = ref
        out[name] = {"losses": losses, "preds": preds, "labels": labels,
                     "rows_u8": rows_u8, "model": model.state_dict(),
                     "gathers": calls[0]}
    return out


def case_wgan(inp, mesh):
    """WGAN-GP steps of one rank: each run of ``inp["runs"]`` (name ->
    (shard, grad_accum)) from the same weights over the same steps (the
    JAX step's draws injected); per run the (steps, critic_iters + 1)
    losses and G's and the critic's state dicts."""
    from xgan_torch.data.pipeline import DeviceStore
    from xgan_torch.models.layers import sync_batch_norm
    from xgan_torch.models.wgan import Critic, Generator
    from xgan_torch.train.common import adam
    from xgan_torch.train.wgan import wgan_step
    latent, fm, size, lr = inp["latent"], inp["fm"], inp["size"], inp["lr"]
    out = {}
    for name, (shard, accum) in inp["runs"].items():
        g, c = Generator(latent, 3, fm, size), Critic(3, fm, size)
        g.load_state_dict(inp["g"])
        c.load_state_dict(inp["c"])
        sync_batch_norm(g, mesh)
        sync_batch_norm(c, mesh)
        opt_g = adam(g.parameters(), lr, 0.5, 0.9)
        opt_c = adam(c.parameters(), lr, 0.5, 0.9)
        store = DeviceStore(_store(inp["images"]), "cpu", mesh, shard=shard)
        losses = [wgan_step(g, c, opt_g, opt_c, store.images, s["idx"],
                            latent_dim=latent,
                            critic_iters=inp["critic_iters"],
                            lambda_gp=inp["lambda_gp"], mask=s["mask"],
                            grad_accum=accum, take=store.take, mesh=mesh,
                            **s["draws"])
                  for s in inp["steps"][:inp["n_steps"][name]]]
        out[name] = {"losses": torch.stack(losses), "g": g.state_dict(),
                     "c": c.state_dict()}
    return out


def case_penalty(inp, mesh):
    """The gradient of a penalty on per-row input-gradient norms through a
    BN-like function of this rank's rows of ``inp["x"]`` (float64): the
    global mean and variance through ``all_reduce_sum``, so the penalty's
    double backward differentiates the all-reduce's backward. Returns
    this rank's part of the weight's gradient and its penalty share."""
    from xgan_torch.parallel.mesh import all_reduce_sum
    x = inp["x"][mesh.local_rows(inp["x"].shape[0])]
    w = inp["w"].clone().requires_grad_(True)
    pen = penalty(x, w, inp["v"], inp["x"].shape[0],
                  lambda t: all_reduce_sum(t, mesh))
    pen.backward()
    return {"dw": w.grad, "pen": pen.detach()}


def case_cgan(inp, mesh):
    """CGAN steps of one rank: each run of ``inp["runs"]`` (name ->
    (cue probe, grad_accum)) from the same weights over its steps (the
    JAX step's draws injected); per run the (steps, 7) metrics, G's and
    D's state dicts and D's after each step."""
    from xgan_torch.data.pipeline import DeviceStore
    from xgan_torch.models.cgan import Discriminator, Generator
    from xgan_torch.models.layers import sync_batch_norm
    from xgan_torch.models.vgg import VGG16Features
    from xgan_torch.train.cgan import cgan_step
    from xgan_torch.train.common import adam
    latent, fm, size, lr = inp["latent"], inp["fm"], inp["size"], inp["lr"]
    out = {}
    for name, (probe, accum) in inp["runs"].items():
        run = inp["data"][name]
        g = Generator(latent, 2, 3, fm, size)
        d = (cue_probe_class() if probe else Discriminator)(2, 3, fm, size)
        vgg = VGG16Features()
        g.load_state_dict(inp["g"])
        d.load_state_dict(inp["d"])
        vgg.load_state_dict(inp["vgg"])
        sync_batch_norm(g, mesh)
        sync_batch_norm(d, mesh)
        opt_g, opt_d = adam(g.parameters(), lr, 0.5), adam(d.parameters(),
                                                           lr, 0.5)
        store = DeviceStore(_store(run["images"], run["labels"]), "cpu",
                            mesh)
        metrics, d_steps = [], []
        for s in run["steps"]:
            metrics.append(cgan_step(
                g, d, vgg, opt_g, opt_d, store.images, store.labels,
                s["idx"], s["epoch"], latent_dim=latent, mask=s["mask"],
                grad_accum=accum, take=store.take, mesh=mesh, **s["draws"]))
            d_steps.append({k: v.clone() for k, v in d.state_dict().items()})
        out[name] = {"metrics": torch.stack(metrics), "g": g.state_dict(),
                     "d": d.state_dict(), "d_steps": d_steps}
    return out


def case_sampler(inp, mesh):
    """``generate_images`` of each generator of ``inp["runs"]`` (name ->
    (kind, state dict, compute dtype)) on this rank's rows, into
    ``inp["out"]/name``; returns each run's count."""
    from xgan_torch.models import cgan, dcgan, wgan
    from xgan_torch.train.sample import generate_images
    classes = {"dcgan": dcgan.Generator, "wgan": wgan.Generator,
               "cgan": cgan.Generator}
    out = {}
    for name, (kind, sd, dtype) in inp["runs"].items():
        g = classes[kind](latent_dim=inp["latent"],
                          feature_maps=inp["fm"], image_size=inp["size"])
        g.load_state_dict(sd)
        out[name] = generate_images(
            g, output_dir=os.path.join(inp["out"], name),
            num_images=inp["num_images"], latent_dim=inp["latent"],
            batch_size=inp["batch_size"], seed=inp["seed"], device="cpu",
            dtype=dtype, conditional=kind == "cgan", mesh=mesh)
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


def _gan_nets(kind, inp, mesh):
    """G, the second net (D or the critic), their Adam, the VGG16 (the
    CGAN's) and the step of ``kind`` (``dcgan``, ``wgan``, ``cgan``),
    from ``inp``'s weights, tied to ``mesh``: ``step(idx, t)`` runs step
    ``t`` with ``inp["draws"][kind][t]`` injected."""
    from xgan_torch.models import cgan, dcgan, wgan
    from xgan_torch.models.layers import sync_batch_norm
    from xgan_torch.models.vgg import VGG16Features
    from xgan_torch.train.cgan import cgan_step
    from xgan_torch.train.common import adam
    from xgan_torch.train.gan import dcgan_step
    from xgan_torch.train.wgan import wgan_step
    latent, fm, size, lr = inp["latent"], inp["fm"], inp["size"], inp["lr"]
    images = torch.as_tensor(inp["images"])
    vgg = None
    if kind == "cgan":
        g, d = cgan.Generator(latent, 2, 3, fm, size), \
            cgan.Discriminator(2, 3, fm, size)
        vgg = VGG16Features()
        vgg.load_state_dict(inp["vgg"])
    elif kind == "wgan":
        g, d = wgan.Generator(latent, 3, fm, size), wgan.Critic(3, fm, size)
    else:
        g, d = dcgan.Generator(latent, 3, fm, size), \
            dcgan.Discriminator(3, fm, size)
    g.load_state_dict(inp["nets"][kind][0])
    d.load_state_dict(inp["nets"][kind][1])
    sync_batch_norm(g, mesh)
    sync_batch_norm(d, mesh)
    b2 = 0.9 if kind == "wgan" else 0.999
    opt_g, opt_d = adam(g.parameters(), lr, 0.5, b2), \
        adam(d.parameters(), lr, 0.5, b2)
    draws = inp["draws"][kind]

    def step(idx, t, opts):
        if kind == "dcgan":
            return dcgan_step(g, d, *opts, images, idx, latent_dim=latent,
                              mesh=mesh, **draws[t])
        if kind == "wgan":
            return wgan_step(g, d, *opts, images, idx, latent_dim=latent,
                             critic_iters=inp["critic_iters"],
                             lambda_gp=10.0, mesh=mesh, **draws[t])
        return cgan_step(g, d, vgg, *opts, images, inp["labels"], idx, 0,
                         latent_dim=latent, mesh=mesh, **draws[t])

    return g, d, (opt_g, opt_d), step


def case_zero1(inp, mesh):
    """ZeRO-1 (``--shard-opt-state``) against replicated Adam on the same
    ranks: for each GAN of ``inp["nets"]`` and each classifier run of
    ``inp["clf_runs"]`` (name -> frozen base), the parameters after
    ``inp["steps"]`` steps both ways, and the numel of each moment this
    rank keeps. ``resumed``: the DCGAN's sharded run whose optimizers go
    through their whole state dict after step 1 (assembled, then cut
    again by fresh sharded optimizers), as a snapshot and a resume do."""
    from xgan_torch.parallel.tp import shard_opt_state
    from xgan_torch.train.classifier import classifier_optimizer, train_step
    out = {}
    idx = inp["idx"]
    for kind in inp["nets"]:
        for run in ("plain", "zero", "resumed"):
            if run == "resumed" and kind != "dcgan":
                continue
            g, d, opts, step = _gan_nets(kind, inp, mesh)
            if run != "plain":
                opts = tuple(shard_opt_state(o, [m], mesh, inp["min"])
                             for o, m in zip(opts, (g, d)))
            for t in range(inp["steps"]):
                step(idx, t, opts)
                if run == "resumed" and t == 0:
                    sds = [o.state_dict() for o in opts]
                    opts = tuple(shard_opt_state(
                        torch.optim.Adam(m.parameters(),
                                         **{k: v for k, v in
                                            o.param_groups[0].items()
                                            if k != "params"}),
                        [m], mesh, inp["min"])
                        for o, m in zip(opts, (g, d)))
                    for o, sd in zip(opts, sds):
                        o.load_state_dict(sd)
            out[f"{kind}_{run}"] = {
                "params": {**{f"g.{k}": v for k, v in g.state_dict().items()},
                           **{f"d.{k}": v for k, v in d.state_dict().items()}},
                "moments": _moment_numel(opts, (g, d))}
    from xgan_torch.data.pipeline import DeviceStore
    from xgan_torch.models.layers import sync_batch_norm
    from xgan_torch.models.resnet import ResNet50
    clf = inp["clf"]
    real = DeviceStore(_store(clf["real"], clf["real_labels"]), "cpu")
    synth = DeviceStore(_store(clf["synth"], clf["synth_labels"]), "cpu")
    for name, frozen in inp["clf_runs"].items():
        for run in ("plain", "zero"):
            model = ResNet50(2, stage_sizes=clf["stages"])
            model.load_state_dict(clf["model"])
            sync_batch_norm(model, mesh)
            opt = classifier_optimizer(model, 1e-3, freeze_base=frozen)
            if run == "zero":
                opt = shard_opt_state(opt, [model], mesh, inp["min"])
            for t in range(inp["steps"]):
                train_step(model, opt, real, synth, clf["idx"], mode="mix",
                           ratio=0.5, mesh=mesh, **clf["draws"][t])
            out[f"{name}_{run}"] = {"params": model.state_dict(),
                                    "moments": _moment_numel((opt,),
                                                             (model,))}
    return out


def _moment_numel(opts, models) -> dict:
    """``{parameter name: numel of its exp_avg on this rank}`` of the
    optimizers' parameters (``nets`` named ``g``/``d`` for two)."""
    names = {}
    for prefix, m in zip(("g.", "d.") if len(models) == 2 else ("",),
                         models):
        for n, p in m.named_parameters():
            names[id(p)] = prefix + n
    out = {}
    for opt in opts:
        wide = {id(s): p for p, s, _ in getattr(opt, "wide", [])}
        for group in opt.param_groups:
            for s in group["params"]:
                st = opt.state.get(s, {})
                if "exp_avg" in st:
                    out[names[id(wide.get(id(s), s))]] = st["exp_avg"].numel()
    return out


def case_kstep(inp, mesh):
    """``--steps-per-call``: each GAN of ``inp["nets"]`` trained
    ``inp["steps"]`` steps as one :class:`StepsPerCall` call of K =
    steps (a plain loop of K steps on the CPU) and as K single steps, the
    draws of step t injected into both; the (K, M) metrics and the
    parameters of each."""
    from xgan_torch.train.multistep import StepsPerCall
    out = {}
    chunk = inp["chunk"]
    for kind in inp["nets"]:
        for k in (1, chunk.shape[0]):
            g, d, opts, step = _gan_nets(kind, inp, mesh)
            calls = iter(range(chunk.shape[0]))

            def one(idx, opts=opts, step=step, calls=calls):
                return step(idx, next(calls), opts)

            if k == 1:
                metrics = torch.stack([one(i) for i in chunk])
            else:
                metrics = StepsPerCall(one, k, torch.Generator())(chunk)
            out[f"{kind}_k{k}"] = {
                "metrics": metrics,
                "params": {**{f"g.{n}": v for n, v in g.state_dict().items()},
                           **{f"d.{n}": v for n, v in d.state_dict().items()}}}
    return out


def case_folds(inp, mesh):
    """``--parallel-folds`` across ranks: for each run of ``inp["runs"]``
    (name -> (k, batch, grad_accum)), one lockstep step of the k folds on
    ``fold_groups(k, world)`` from ``inp``'s weights and draws
    (``inp["mix"][name]``, its ``accum`` the step's ``grad_accum``):
    this rank's fold slice, its (k/f, B/n) losses and labels, every fold's
    outputs gathered, each owned fold's state dict (and every fold's, by
    broadcast), and the step's ``mixed_gather`` calls with the indices
    each got."""
    from xgan_torch.data.pipeline import DeviceStore
    from xgan_torch.kernels import gather as gather_mod
    from xgan_torch.models.resnet import ResNet50
    from xgan_torch.models.layers import sync_batch_norm
    from xgan_torch.train import parallel_folds as pf
    from xgan_torch.train.parallel_cv import FoldLayout
    real = DeviceStore(_store(inp["real"], inp["real_labels"]), "cpu")
    synth = DeviceStore(_store(inp["synth"], inp["synth_labels"]), "cpu")
    out = {}
    for name, (k, _, _) in inp["runs"].items():
        run = inp["mix"][name]
        layout = FoldLayout(mesh, k)
        models = []
        for f in range(layout.folds.start, layout.folds.stop):
            m = ResNet50(2, stage_sizes=inp["stages"])
            m.load_state_dict(inp["models"][f])
            models.append(m)
        stack = pf.FoldStack(models, [n for n, _ in
                                      models[0].named_parameters()])
        sync_batch_norm(stack.model, layout.group)
        opt = pf.FoldAdam(stack.trainable, stack.k, inp["lr"])
        calls = []
        ref = gather_mod.mixed_gather_ref

        def counted(real_, synth_, r_idx, s_idx, use, *a, **kw):
            calls.append(r_idx.clone())
            return ref(real_, synth_, r_idx, s_idx, use, *a, **kw)

        gather_mod.mixed_gather_ref = counted
        try:
            mine = pf.lockstep_train_step(
                stack, opt, real, synth, run["idx"], run["mask"],
                mode="mix", ratio=0.5, mesh=layout.group,
                folds=layout.folds, use_synth=run["use_synth"],
                synth_pick=run["synth_pick"], flip=run["flip"],
                grad_accum=run["accum"])
        finally:
            gather_mod.mixed_gather_ref = ref
        every = layout.gather(mine, run["idx"].shape[1], run["accum"])
        out[name] = {"folds": (layout.folds.start, layout.folds.stop),
                     "mine": mine, "every": every, "gathers": calls,
                     "states": [layout.state_dict(stack, f)
                                for f in range(k)]}
    return out


def tp_net(x, w1, w2, w3, b3, model):
    """A small tensor-parallel network of the three operators (float64):
    ``x (B, C)`` through a column-parallel ``w1`` (C, H/N), its slices
    gathered, a column-parallel ``w2`` (H, K/N), and a row-parallel ``w3``
    (K/N, O) whose partial products are summed over the model group, then
    the bias; with ``model`` None (whole weights) the one-process
    function."""
    from xgan_torch.parallel.tp import (copy_to_model, gather_from_model,
                                        reduce_from_model)
    h = torch.tanh(copy_to_model(x, model) @ w1)
    h = gather_from_model(h, model, 1)
    h = torch.tanh(copy_to_model(h, model) @ w2)
    return reduce_from_model(h @ w3, model) + b3


def tp_penalty(x, ws, model, n: int):
    """The first and second derivatives through :func:`tp_net`: the input
    gradient of its summed outputs over the rows ``x`` (kept in the graph)
    and the penalty ``sum_i (||g_i|| - 1)^2 / n`` on its rows' norms,
    differentiable in the weights (the double backward that WGAN-GP's
    penalty takes)."""
    x = x.clone().requires_grad_(True)
    g, = torch.autograd.grad(tp_net(x, *ws, model).sum(), x,
                             create_graph=True)
    return g, (g.norm(dim=1) - 1.0).square().sum() / n


def _tp_gan(inp, mesh, run):
    """One tensor-parallel DCGAN run of :func:`case_tp`."""
    from xgan_torch.models.dcgan import Discriminator, Generator
    from xgan_torch.models.layers import sync_batch_norm
    from xgan_torch.parallel import tp
    from xgan_torch.train.common import adam
    from xgan_torch.train.gan import dcgan_step
    from xgan_torch.train.multistep import StepsPerCall
    gi = inp["gan"]
    latent, fm, size = gi["latent"], gi["fm"], gi["size"]
    g, d = Generator(latent, 3, fm, size), Discriminator(3, fm, size)
    g.load_state_dict(gi["g"])
    d.load_state_dict(gi["d"])
    sync_batch_norm(g, mesh)
    sync_batch_norm(d, mesh)
    tp.shard_over_model([g, d], mesh.model, inp["min"])
    opts = [adam(m.parameters(), gi["lr"], 0.5) for m in (g, d)]
    if run == "zero":
        opts = [tp.shard_opt_state(o, [m], mesh, inp["min"])
                for o, m in zip(opts, (g, d))]
    images = gi["images"]
    steps = gi["steps"] if run != "accum" else gi["steps"][:1]
    calls = iter(steps)

    def one(idx):
        s = next(calls)
        return dcgan_step(g, d, *opts, images, idx, latent_dim=latent,
                          flip=s["flip"], noise=s["noise"], mesh=mesh,
                          grad_accum=2 if run == "accum" else 1)

    idx = torch.stack([s["idx"] for s in steps])
    if run == "k2":
        metrics = StepsPerCall(one, 2, torch.Generator())(idx)
    else:
        metrics = torch.stack([one(i) for i in idx])
    return {"metrics": metrics,
            "whole": {"g": tp.whole_state_dict(g),
                      "d": tp.whole_state_dict(d)},
            "local": {"g": g.state_dict(), "d": d.state_dict()},
            "dims": {"g": g.tp_dims, "d": d.tp_dims},
            "opt_whole": [tp.whole_opt_state_dict(o) for o in opts]}


def _tp_clf(inp, mesh, run):
    """One tensor-parallel classifier run of :func:`case_tp`: 3 steps
    with the base frozen, or 1 unfrozen (with ``remat`` too), then the
    eval step on the first 16 rows."""
    from xgan_torch.data.pipeline import DeviceStore
    from xgan_torch.models.layers import sync_batch_norm
    from xgan_torch.models.resnet import ResNet50
    from xgan_torch.parallel import tp
    from xgan_torch.train.classifier import (classifier_optimizer,
                                             eval_step, train_step)
    ci = inp["clf"]
    model = ResNet50(2, stage_sizes=ci["stages"], remat=run == "remat")
    model.load_state_dict(ci["model"])
    sync_batch_norm(model, mesh)
    tp.shard_over_model([model], mesh.model, inp["min"])
    frozen = run == "frozen"
    opt = classifier_optimizer(model, ci["lr"], freeze_base=frozen)
    store = DeviceStore(_store(ci["images"], ci["labels"]), "cpu", mesh)
    losses = [train_step(model, opt, store, store, s["idx"], mode="real",
                         flip=s["flip"], mesh=mesh)[0]
              for s in ci["steps"][:3 if frozen else 1]]
    ev = eval_step(model, store, torch.arange(16), mesh=mesh)
    return {"losses": torch.stack(losses), "eval": ev,
            "whole": tp.whole_state_dict(model),
            "local": model.state_dict(), "dims": model.tp_dims}


def case_tp(inp, mesh):
    """Tensor parallelism on the ``(data, model)`` layout of
    ``inp["model_parallel"]``: the DCGAN runs (``tp``: the K = 1 steps,
    ``k2``: one K = 2 call, ``zero``: ZeRO-1 over the data group,
    ``accum``: one ``--grad-accum 2`` step), the classifier runs
    (``frozen``, ``unfrozen``, ``remat``), the round trips of
    ``shard_over_model`` and ``whole_state_dict`` (a 64-px G, whose first
    ConvT packs 2 x 2 pixels, included), and the float64 first and second
    derivatives of :func:`tp_penalty` on this rank's data rows."""
    from xgan_torch.models.dcgan import Discriminator, Generator
    from xgan_torch.models.resnet import ResNet50
    from xgan_torch.parallel import tp
    from xgan_torch.parallel.mesh import all_reduce_grads
    data, model = mesh.split_model(inp["model_parallel"])
    out = {"data_rank": data.rank, "model_rank": model.rank,
           "is_main": data.is_main}
    for run in ("tp", "k2", "zero", "accum"):
        out[f"gan_{run}"] = _tp_gan(inp, data, run)
    for run in ("frozen", "unfrozen", "remat"):
        out[f"clf_{run}"] = _tp_clf(inp, data, run)
    gi, ci = inp["gan"], inp["clf"]
    nets = {"g32": (Generator(gi["latent"], 3, gi["fm"], 32), gi["g"]),
            "g64": (Generator(gi["latent"], 3, gi["fm"], 64), inp["g64"]),
            "d": (Discriminator(3, gi["fm"], 32), gi["d"]),
            "resnet": (ResNet50(2, stage_sizes=ci["stages"]), ci["model"])}
    out["round_trip"] = {}
    for name, (net, sd) in nets.items():
        net.load_state_dict(sd)
        tp.shard_over_model([net], model, inp["min"])
        out["round_trip"][name] = {
            "whole": tp.whole_state_dict(net), "local": net.state_dict(),
            "dims": net.tp_dims,
            "w0_mat": net.w0_mat.clone() if name[0] == "g" else None}
    ops = inp["ops"]
    ws = [w.clone() for w in ops["ws"]]
    n = model.world
    for i, dim in ((0, 1), (1, 1), (2, 0)):  # w1, w2 columns; w3 rows
        k = ws[i].shape[dim] // n
        ws[i] = ws[i].narrow(dim, model.rank * k, k).clone()
    ws = [w.requires_grad_(True) for w in ws]
    for w in ws[:3]:
        w.tp_dim = 0  # sliced: no broadcast of its gradient
    rows = data.local_rows(ops["x"].shape[0])
    g, pen = tp_penalty(ops["x"][rows], ws, model, ops["x"].shape[0])
    pen.backward()
    all_reduce_grads(ws, data)
    out["ops"] = {"dx": g.detach(), "grads": [w.grad for w in ws]}
    return out


def _tp_nets(kind: str, gi: dict, model):
    """The WGAN-GP (G, critic) or CGAN (G, D) of ``gi``'s size from its
    whole weights, placed over the model group ``model`` (none: whole)."""
    from xgan_torch.models import cgan, wgan
    from xgan_torch.parallel import tp
    latent, fm, size = gi["latent"], gi["fm"], gi["size"]
    if kind == "wgan":
        nets = wgan.Generator(latent, 3, fm, size), wgan.Critic(3, fm, size)
    else:
        nets = (cgan.Generator(latent, 2, 3, fm, size),
                cgan.Discriminator(2, 3, fm, size))
    for net, sd in zip(nets, (gi["g"], gi["d"])):
        net.load_state_dict(sd)
    if model is not None:
        tp.shard_over_model(nets, model, gi["min"])
    return nets


def _tp_family(kind: str, gi: dict, data, run: str):
    """One tensor-parallel WGAN-GP or CGAN run of :func:`case_tp_gans` on
    the data group ``data`` (carrying its model group): ``tp`` (the K = 1
    steps), ``k2`` (one K = 2 call, WGAN-GP) or ``accum`` (one
    ``--grad-accum 2`` step). Returns the metrics, the whole and local
    states and the sliced leaves' dimensions."""
    from xgan_torch.models.layers import sync_batch_norm
    from xgan_torch.models.vgg import VGG16Features
    from xgan_torch.parallel import tp
    from xgan_torch.train.cgan import cgan_step
    from xgan_torch.train.common import adam
    from xgan_torch.train.multistep import StepsPerCall
    from xgan_torch.train.wgan import wgan_step
    g, d = _tp_nets(kind, gi, None)
    for net in (g, d):
        sync_batch_norm(net, data)
    tp.shard_over_model([g, d], data.model, gi["min"])
    b2 = 0.9 if kind == "wgan" else 0.999
    opts = [adam(m.parameters(), gi["lr"], 0.5, b2) for m in (g, d)]
    vgg = None
    if kind == "cgan":
        vgg = VGG16Features()
        vgg.load_state_dict(gi["vgg"])
    steps = gi["steps"] if run != "accum" else gi["steps"][:1]
    calls = iter(steps)
    accum = 2 if run == "accum" else 1

    def one(idx):
        s = next(calls)
        if kind == "wgan":
            return wgan_step(g, d, *opts, gi["images"], idx,
                             latent_dim=gi["latent"],
                             critic_iters=gi["critic_iters"],
                             lambda_gp=gi["lambda_gp"], grad_accum=accum,
                             mesh=data, **s["draws"])
        return cgan_step(g, d, vgg, *opts, gi["images"], gi["labels"], idx,
                         s["epoch"], latent_dim=gi["latent"],
                         grad_accum=accum, mesh=data, **s["draws"])

    idx = torch.stack([s["idx"] for s in steps])
    if run == "k2":
        metrics = StepsPerCall(one, 2, torch.Generator())(idx)
    else:
        metrics = torch.stack([one(i) for i in idx])
    return {"metrics": metrics,
            "whole": {"g": tp.whole_state_dict(g),
                      "d": tp.whole_state_dict(d)},
            "local": {"g": g.state_dict(), "d": d.state_dict()},
            "dims": {"g": g.tp_dims, "d": d.tp_dims}}


def tp_critic_penalty(c, pen: dict, rows, mesh):
    """The float64 WGAN-GP penalty of ``pen``'s rows ``rows`` through the
    critic ``c`` (``gradient_penalty``, BN over ``mesh``'s ranks; None:
    one process), its backward and the gradients summed over the data
    group; returns the penalty share and ``{name: gradient}``."""
    from xgan_torch.parallel.mesh import all_reduce_grads
    from xgan_torch.parallel.tp import one_autograd_thread
    from xgan_torch.train.wgan import gradient_penalty
    pen_v = gradient_penalty(c, pen["real"][rows], pen["fake"][rows],
                             pen["alpha"][rows], 10.0, mesh=mesh)
    with one_autograd_thread(c):
        pen_v.backward()
    all_reduce_grads(list(c.parameters()), mesh)
    return pen_v.detach(), {n: p.grad for n, p in c.named_parameters()}


def case_tp_gans(inp, mesh):
    """Tensor parallelism of the WGAN-GP and CGAN steps on the ``(data,
    model)`` layout of ``inp["model_parallel"]``: per family the runs of
    :func:`_tp_family` (``tp``, ``accum``; ``k2`` for the WGAN-GP), the
    round trips of ``shard_over_model`` and ``whole_state_dict`` of each
    net, the CGAN's FM loss through D's gathered taps (this data rank's
    share summed over the data group), and the float64 penalty gradient
    through a column-parallel critic with BN over the data group
    (:func:`tp_critic_penalty`), also after model rank 0 alone has run a
    differentiated penalty of its own."""
    from xgan_torch.models.layers import sync_batch_norm
    from xgan_torch.parallel import tp
    from xgan_torch.train.cgan import feature_matching_loss
    data, model = mesh.split_model(inp["model_parallel"])
    out = {"data_rank": data.rank, "model_rank": model.rank}
    for kind in ("wgan", "cgan"):
        gi = {**inp[kind], "min": inp["min"]}
        for run in ("tp", "accum", "k2")[:3 if kind == "wgan" else 2]:
            out[f"{kind}_{run}"] = _tp_family(kind, gi, data, run)
        out[f"{kind}_round_trip"] = {
            name: {"whole": tp.whole_state_dict(net),
                   "local": net.state_dict(), "dims": net.tp_dims}
            for name, net in zip(("g", "d"), _tp_nets(kind, gi, model))}
    # the FM loss over D's taps: real and fake rows, both placed alike
    gi = {**inp["cgan"], "min": inp["min"]}
    fm_in = inp["fm"]
    _, d = _tp_nets("cgan", gi, None)
    sync_batch_norm(d, data)
    tp.shard_over_model([d], model, inp["min"])
    rows = data.local_rows(fm_in["real"].shape[0])
    feats = [d(fm_in[k][rows], fm_in["labels"][rows], train=True,
               features=True)[1] for k in ("real", "fake")]
    fm = feature_matching_loss(*feats, mesh=data).detach()
    out["fm"] = {"loss": data.all_reduce_(fm),
                 "shapes": [tuple(f.shape) for f in feats[0]]}
    # the float64 penalty through the column-parallel critic; again after
    # model rank 0 alone runs a differentiated penalty of its own
    from xgan_torch.models.wgan import Critic
    pen, wi = inp["penalty"], inp["wgan"]

    def critic():
        c = Critic(3, wi["fm"], wi["size"])
        c.double()
        c.dtype = torch.float64
        c.load_state_dict(pen["c"])
        return c

    for run in ("penalty", "penalty_after_lone"):
        if run == "penalty_after_lone" and model.rank == 0:
            tp_critic_penalty(critic(), pen, slice(None), None)
        c = critic()
        sync_batch_norm(c, data)
        tp.shard_over_model([c], model, inp["min"])
        value, grads = tp_critic_penalty(
            c, pen, data.local_rows(pen["real"].shape[0]), data)
        out[run] = {"value": data.all_reduce_(value), "grads": grads,
                    "dims": c.tp_dims}
    return out


CASES = {"gan": case_gan, "bn": case_bn, "classifier": case_classifier,
         "take": case_take, "wgan": case_wgan, "penalty": case_penalty,
         "cgan": case_cgan, "sampler": case_sampler, "zero1": case_zero1,
         "kstep": case_kstep, "folds": case_folds,
         "tp": case_tp, "tp_gans": case_tp_gans}


def main(in_path: str, out_dir: str) -> None:
    sys.path.insert(0, ROOT)
    torch.set_num_threads(1)
    from xgan_torch.parallel.mesh import init_from_env, shutdown
    mesh = init_from_env(cpu=True)
    try:
        inputs = torch.load(in_path, weights_only=True)
        # "case" or "case:label", so that one launch runs a case twice
        out = {case: CASES[case.split(":")[0]](inp, mesh)
               for case, inp in inputs.items()}
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


def run_cases(inputs: dict, tmp, world: int = 2,
              timeout: float = RANK_TIMEOUT) -> dict:
    """Run the cases of ``inputs`` on ``world`` gloo ranks; returns case
    name -> [each rank's outputs]."""
    tmp = str(tmp)
    in_path = os.path.join(tmp, "in.pt")
    torch.save(inputs, in_path)
    outs = wait_ranks(start_ranks(
        [sys.executable, os.path.abspath(__file__), in_path, tmp], world),
        timeout)
    for rc, text in outs:
        assert rc == 0, text[-4000:]
    ranks = [torch.load(os.path.join(tmp, f"rank{r}.pt"), weights_only=True)
             for r in range(world)]
    return {case: [r[case] for r in ranks] for case in inputs}


if __name__ == "__main__":
    main(*sys.argv[1:3])
