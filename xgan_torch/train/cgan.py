"""One CGAN train step (role of xgan/train/cgan.py, ``step_plain``).

The reference iteration (train_cgan.py:156-193), in the JAX package's
order:

1. the real batch gathered, flipped and normalized on the device; the
   draws; one G forward in train mode, kept for G's backward (G's BN
   statistics advance once);
2. D on the real batch and on ``fake.detach()``, two BN batches, against
   per-sample noisy targets (real ``0.9 - 0.1 U``, fake ``0.1 + 0.1 U``);
3. the adaptive gate ``D(x) < 0.8 or D(G(z)) > 0.2 or epoch < 5`` as a
   select on the device (:func:`gated_step`): D's backward and Adam step
   always run, then ``torch.where(gate, new, old)`` puts back D's
   parameters and its Adam state (``exp_avg``, ``exp_avg_sq`` and
   ``step``, which ``Adam.step`` advances even on a zero gradient) when
   the gate is closed, so a closed gate leaves them bitwise untouched
   while D's BN statistics have advanced. ``epoch`` may be a device
   scalar: nothing in the step reads the device on the host, so it can
   be captured into a CUDA graph whose replays read the epoch of each
   call;
4. D on ``fake`` with ``features=True`` through the possibly updated D,
   then on the real batch under ``no_grad`` (D's BN statistics advance
   four times a step);
5. ``loss_G = adv + 10 perceptual + 5 fm``: the BCE of the fake logits
   against the real targets, the VGG perceptual loss (the real side
   under ``no_grad``) and the feature-matching loss over D's 14
   activations; its backward takes G's parameters only (``backward(
   inputs=...)``: no D weight gradient is computed), then G's Adam step.

A (B,) ``mask`` of a padded tail batch enters every BN statistic, every
loss and metric mean, and each layer's mean in the perceptual and FM
losses. Metrics stay on the device.

``grad_accum=A > 1`` (``step_accum`` of the JAX package) runs the D and
the G update each as A sequential microbatches of B/A rows, with A = 1's
draws (flip, noise, fake labels, targets, over the full batch) sliced:
a D phase per microbatch (G's forward under ``no_grad``, its running
statistics advancing once per microbatch; D on the real and fake rows;
the backward of the valid-row BCE *sum*), the gradients divided by the
batch's valid-row total, the gate on the accumulated full-batch D(x) and
D(G(z)) (the inputs of A = 1's gate), D's gated Adam step; then a G phase
per microbatch through the updated D (G's forward recomputed without
advancing its statistics again; D on the fake rows with features, then
on the real rows; the adversarial, perceptual and FM losses as valid-row
sums) and one G Adam step. A microbatch whose rows are all padding is
skipped: its statistics stay frozen and it adds a zero gradient.

Across data-parallel ranks (``mesh``, a joined process group; G's and
D's BN tied to it by ``sync_batch_norm``; the frozen VGG16 the same on
every rank) every rank draws the global batch's flip, noise, fake labels
and targets from the same seed and takes its rows
(``MeshContext.local_rows``). Every BN batch is global, every loss mean
(the BCEs, each VGG block's and each of D's 14 feature MSEs) takes a
global denominator and is this rank's share, and the gradients are
summed over the ranks before each Adam step. The gate reads the
all-reduced global D(x) and D(G(z)), not this rank's shares: every rank
then takes the same decision and the parameters stay bitwise equal.
With ``grad_accum`` a rank holds its share of each microbatch, as in
:mod:`xgan_torch.train.gan`.

Under ``--model-parallel`` ``mesh`` is the data group of the ``(data,
model)`` layout: the ranks of one model group take the same rows and
draws, compute G and D column-parallel (:mod:`xgan_torch.models.cgan`)
and count their shared losses once; the frozen VGG16 is whole on every
rank. D's ``features=True`` forward gathers the taps of its sliced layers
whole, so the FM loss (each tap's mean, :func:`layerwise_mse`, or its
valid-row sum with ``grad_accum``) is one process's on every rank of the
group, the real-feature pass under ``no_grad`` issuing the same gathers
in the same order; a tap's gradient keeps this rank's slice. (Summing
each slice's squared error over the model group through
``reduce_from_model`` would move less, but would change the loss's
reduction order from one process's and need a whole-tap count in every
mean.) The gate reads the whole logits, the same on every rank of the
group, through the data group's all-reduced D(x) and D(G(z)).
``all_reduce_grads`` broadcasts the replicated parameters' gradients
over the model group after each update; G's ``fc.bias``, a pre-BN bias
whose gradient is rounding noise, is a slice under TP.
"""
from __future__ import annotations

import torch

from xgan_torch.data.pipeline import gather_preprocess, take_rows
from xgan_torch.models.vgg import perceptual_loss
from xgan_torch.ops.reduce import layerwise_mse, per_sample_mse, \
    weighted_mean
from xgan_torch.parallel.mesh import all_reduce_grads
from xgan_torch.train.common import bce_sum, bce_with_logits, guarded_sum, \
    microbatches, zeroed_grads

PERCEPTUAL_WEIGHT = 10.0
FM_WEIGHT = 5.0
GATE_EPOCHS = 5  # the D update always runs in the first epochs


def feature_matching_loss(real_feats, fake_feats, weights=None, mesh=None):
    """Sum of per-layer MSEs (reference train_cgan.py:75-76); ``weights``
    (B,) restricts each layer's mean to the valid rows; ``mesh``: this
    rank's share of the global loss."""
    return layerwise_mse(real_feats, fake_feats, weights, mesh)


def gate_open(epoch, d_x: torch.Tensor, d_g_z1: torch.Tensor
              ) -> torch.Tensor:
    """The adaptive gate as a 0-dim device bool; ``epoch`` an int or a
    device scalar."""
    return (d_x < 0.8) | (d_g_z1 > 0.2) | (epoch < GATE_EPOCHS)


@torch.no_grad()
def gated_step(opt: torch.optim.Optimizer, gate: torch.Tensor) -> None:
    """``opt.step()`` that takes effect only where ``gate`` is true: the
    parameters and every tensor of their optimizer state (Adam's
    ``exp_avg``, ``exp_avg_sq``, ``step``) are selected back to their
    values before the step when it is false. A state that the step
    created is selected against zeros, the state it starts from. A
    ``step`` kept on the host (Adam without ``capturable``, on a CUDA
    parameter) takes the gate to the host; the trainers' Adam on the card
    is capturable. A ZeRO-1 :class:`~xgan_torch.parallel.tp.ShardedAdam`
    gates the step of its slices, before it assembles the parameters."""
    if hasattr(opt, "inner"):
        opt.step(lambda inner: gated_step(inner, gate))
        return
    params = [p for group in opt.param_groups for p in group["params"]]
    old_params = [p.detach().clone() for p in params]
    old_state = [{k: v.clone() for k, v in opt.state[p].items()
                  if torch.is_tensor(v)} for p in params]
    opt.step()
    news, olds = [], []
    for p, old_p, old_st in zip(params, old_params, old_state):
        news.append(p)
        olds.append(old_p)
        for k, v in opt.state[p].items():
            if torch.is_tensor(v):
                news.append(v)
                olds.append(old_st.get(k, torch.zeros_like(v)))
    for new, old in zip(news, olds):
        new.copy_(torch.where(gate.to(new.device), new, old))


def cgan_step(g, d, vgg, opt_g, opt_d, store_u8, labels_all, idx,
              epoch, *, latent_dim: int,
              dtype: torch.dtype = torch.float32, mask=None, flip=None,
              noise=None, fake_labels=None, real_targets=None,
              fake_targets=None, generator: torch.Generator | None = None,
              grad_accum: int = 1, take=take_rows,
              mesh=None) -> torch.Tensor:
    """One iteration; returns the (7,) device tensor ``[loss_G, loss_D,
    D_x, D_G_z1, D_G_z2, perceptual, fm]``, without a host sync unless
    ``grad_accum > 1`` and a ``mask`` is given (it then reads which
    microbatches hold valid rows).

    ``store_u8`` (N,S,S,3) uint8, ``labels_all`` (N,) int and ``idx`` (B,)
    int64 live on the device; ``epoch`` is the run's epoch, an int or a
    0-dim device tensor. The draws, unless injected, come from
    ``generator`` on the device in this order: the flip mask, the (B,
    latent) noise, the fake labels (uniform over G's ``num_classes``), the
    real targets ``0.9 - 0.1 U`` and the fake targets ``0.1 + 0.1 U``.
    ``grad_accum``: microbatches per update (it must divide B).
    ``take``: the store's gather (``DeviceStore.take``); ``mesh``: the
    step of one data-parallel rank (see the module docstring)."""
    dev = store_u8.device
    dp = mesh is not None and mesh.distributed
    b = idx.shape[0]
    rows = mesh.local_rows(b, grad_accum) if dp else slice(None)
    real = gather_preprocess(store_u8, idx, flip=flip, generator=generator,
                             dtype=dtype, take=take, rows=rows)
    real_labels = labels_all.index_select(0, idx[rows])
    if noise is None:
        noise = torch.randn((b, latent_dim), generator=generator, device=dev)
    if fake_labels is None:
        fake_labels = torch.randint(0, g.num_classes, (b,),
                                    generator=generator, device=dev)
    if real_targets is None:
        real_targets = 0.9 - 0.1 * torch.rand(b, generator=generator,
                                              device=dev)
    if fake_targets is None:
        fake_targets = 0.1 + 0.1 * torch.rand(b, generator=generator,
                                              device=dev)
    noise, fake_labels, real_targets, fake_targets = (
        t[rows] for t in (noise, fake_labels, real_targets, fake_targets))
    if mask is not None:
        mask = mask[rows]
    if grad_accum > 1:
        metrics = _step_accum(g, d, vgg, opt_g, opt_d, epoch, real,
                              real_labels, noise, fake_labels, real_targets,
                              fake_targets, mask, b, grad_accum, mesh)
        return mesh.all_reduce_(metrics) if dp else metrics
    fake = g.forward_train(noise, fake_labels, mask)

    opt_d.zero_grad(set_to_none=True)
    d_params = list(d.parameters())
    logits_real = d(real, real_labels, train=True, mask=mask)
    logits_fake = d(fake.detach(), fake_labels, train=True, mask=mask)
    loss_d = (bce_with_logits(logits_real, real_targets, mask, mesh)
              + bce_with_logits(logits_fake, fake_targets, mask, mesh))
    with torch.no_grad():
        # this rank's shares of D(x) and D(G(z)); the gate reads the
        # global values, so that every rank takes the same decision
        d_probs = torch.stack([
            weighted_mean(torch.sigmoid(logits_real), mask, mesh),
            weighted_mean(torch.sigmoid(logits_fake), mask, mesh)])
        gate_in = mesh.all_reduce_(d_probs.clone()) if dp else d_probs
    loss_d.backward()
    all_reduce_grads(d_params, mesh)
    gated_step(opt_d, gate_open(epoch, gate_in[0], gate_in[1]))

    opt_g.zero_grad(set_to_none=True)
    g_params = list(g.parameters())
    logits, fake_feats = d(fake, fake_labels, train=True, features=True,
                           mask=mask)
    with torch.no_grad():
        _, real_feats = d(real, real_labels, train=True, features=True,
                          mask=mask)
    adv = bce_with_logits(logits, real_targets, mask, mesh)
    perc = perceptual_loss(vgg, fake, real, mask, mesh)
    fm = feature_matching_loss(real_feats, fake_feats, mask, mesh)
    loss_g = adv + PERCEPTUAL_WEIGHT * perc + FM_WEIGHT * fm
    loss_g.backward(inputs=g_params)
    all_reduce_grads(g_params, mesh)
    opt_g.step()

    with torch.no_grad():
        d_g_z2 = weighted_mean(torch.sigmoid(logits), mask, mesh)
        metrics = torch.stack([loss_g, loss_d, *d_probs, d_g_z2, perc,
                               fm]).detach()
        return mesh.all_reduce_(metrics) if dp else metrics


def _feats_mse_sum(feats_a, feats_b, mask_mb) -> torch.Tensor:
    """The valid-row sum form of :func:`layerwise_mse`: the sum over
    layers of each valid row's MSE (divided by the batch's valid rows
    once, at the end)."""
    total = 0.0
    for a, b in zip(feats_a, feats_b):
        total = total + guarded_sum(per_sample_mse(a, b), mask_mb)
    return total


def _step_accum(g, d, vgg, opt_g, opt_d, epoch, real, real_labels, noise,
                fake_labels, real_targets, fake_targets, mask, b: int,
                accum: int, mesh) -> torch.Tensor:
    """``cgan_step`` with ``grad_accum=accum`` over this rank's rows of
    the global batch of ``b``; see the module docstring. Returns this
    rank's share of the metrics."""
    w_total, micro = microbatches(mask, b, accum, mesh)
    zero = real.new_zeros((), dtype=torch.float32)
    ds = dxs = dgz1s = zero
    d_params = list(d.parameters())
    d_grads = zeroed_grads(d_params)
    for rows, mask_mb in micro:
        flab = rows(fake_labels)
        with torch.no_grad():
            fake = g.forward_train(rows(noise), flab, mask_mb)
        logits_real = d(rows(real), rows(real_labels), train=True,
                        mask=mask_mb)
        logits_fake = d(fake, flab, train=True, mask=mask_mb)
        s = (bce_sum(logits_real, rows(real_targets), mask_mb)
             + bce_sum(logits_fake, rows(fake_targets), mask_mb))
        s.backward()
        with torch.no_grad():
            ds = ds + s
            dxs = dxs + guarded_sum(torch.sigmoid(logits_real.float()),
                                    mask_mb)
            dgz1s = dgz1s + guarded_sum(torch.sigmoid(logits_fake.float()),
                                        mask_mb)
    torch._foreach_div_(d_grads, w_total)
    all_reduce_grads(d_params, mesh)
    # the gate on the global D(x) and D(G(z)), the same on every rank
    gate_in = torch.stack([dxs, dgz1s]) / w_total
    if mesh is not None and mesh.distributed:
        gate_in = mesh.all_reduce_(gate_in)
    gated_step(opt_d, gate_open(epoch, gate_in[0], gate_in[1]))

    gs = dgz2s = percs = fms = zero
    g_params = list(g.parameters())
    g_grads = zeroed_grads(g_params)
    for rows, mask_mb in micro:
        flab, real_mb = rows(fake_labels), rows(real)
        fake = g.forward_train(rows(noise), flab, mask_mb,
                               update_stats=False)
        logits, fake_feats = d(fake, flab, train=True, features=True,
                               mask=mask_mb)
        with torch.no_grad():
            _, real_feats = d(real_mb, rows(real_labels), train=True,
                              features=True, mask=mask_mb)
            vgg_real = vgg(real_mb)
        adv = bce_sum(logits, rows(real_targets), mask_mb)
        perc = _feats_mse_sum(vgg(fake), vgg_real, mask_mb)
        fm = _feats_mse_sum(real_feats, fake_feats, mask_mb)
        s = adv + PERCEPTUAL_WEIGHT * perc + FM_WEIGHT * fm
        s.backward(inputs=g_params)
        with torch.no_grad():
            gs = gs + s
            dgz2s = dgz2s + guarded_sum(torch.sigmoid(logits.float()),
                                        mask_mb)
            percs = percs + perc
            fms = fms + fm
    torch._foreach_div_(g_grads, w_total)
    all_reduce_grads(g_params, mesh)
    opt_g.step()
    return torch.stack([gs, ds, dxs, dgz1s, dgz2s, percs,
                        fms]).detach() / w_total
