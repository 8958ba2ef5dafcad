"""One CGAN train step (role of xgan/train/cgan.py, ``step_plain``).

The reference iteration (train_cgan.py:156-193), in the JAX package's
order:

1. the real batch gathered, flipped and normalized on the device; the
   draws; one G forward in train mode, kept for G's backward (G's BN
   statistics advance once);
2. D on the real batch and on ``fake.detach()``, two BN batches, against
   per-sample noisy targets (real ``0.9 - 0.1 U``, fake ``0.1 + 0.1 U``);
3. the adaptive gate ``D(x) < 0.8 or D(G(z)) > 0.2 or epoch < 5``: D's
   backward and Adam step run only when it is open, so a closed gate
   leaves D's parameters and its Adam state (``exp_avg``,
   ``exp_avg_sq``, ``step``) untouched while its BN statistics have
   advanced. The gate is read on the host: one sync per step from epoch
   5 on, none before. That is the exact form (``Adam.step`` advances
   ``step`` even on zero gradients);
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
losses. Metrics stay on the device. ``--grad-accum`` (``step_accum``) is
not ported yet (ROADMAP A13).
"""
from __future__ import annotations

import torch

from xgan_torch.data.pipeline import gather_preprocess
from xgan_torch.models.vgg import perceptual_loss
from xgan_torch.ops.reduce import layerwise_mse, weighted_mean
from xgan_torch.train.common import bce_with_logits

PERCEPTUAL_WEIGHT = 10.0
FM_WEIGHT = 5.0
GATE_EPOCHS = 5  # the D update always runs in the first epochs


def feature_matching_loss(real_feats, fake_feats, weights=None):
    """Sum of per-layer MSEs (reference train_cgan.py:75-76); ``weights``
    (B,) restricts each layer's mean to the valid rows."""
    return layerwise_mse(real_feats, fake_feats, weights)


def cgan_step(g, d, vgg, opt_g, opt_d, store_u8, labels_all, idx,
              epoch: int, *, latent_dim: int,
              dtype: torch.dtype = torch.float32, mask=None, flip=None,
              noise=None, fake_labels=None, real_targets=None,
              fake_targets=None,
              generator: torch.Generator | None = None) -> torch.Tensor:
    """One iteration; returns the (7,) device tensor ``[loss_G, loss_D,
    D_x, D_G_z1, D_G_z2, perceptual, fm]``.

    ``store_u8`` (N,S,S,3) uint8, ``labels_all`` (N,) int and ``idx`` (B,)
    int64 live on the device. The draws, unless injected, come from
    ``generator`` on the device in this order: the flip mask, the (B,
    latent) noise, the fake labels (uniform over G's ``num_classes``), the
    real targets ``0.9 - 0.1 U`` and the fake targets ``0.1 + 0.1 U``."""
    dev = store_u8.device
    b = idx.shape[0]
    real = gather_preprocess(store_u8, idx, flip=flip, generator=generator,
                             dtype=dtype)
    real_labels = labels_all.index_select(0, idx)
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
    fake = g.forward_train(noise, fake_labels, mask)

    opt_d.zero_grad(set_to_none=True)
    logits_real = d(real, real_labels, train=True, mask=mask)
    logits_fake = d(fake.detach(), fake_labels, train=True, mask=mask)
    loss_d = (bce_with_logits(logits_real, real_targets, mask)
              + bce_with_logits(logits_fake, fake_targets, mask))
    with torch.no_grad():
        d_x = weighted_mean(torch.sigmoid(logits_real), mask)
        d_g_z1 = weighted_mean(torch.sigmoid(logits_fake), mask)
    if epoch < GATE_EPOCHS or bool((d_x < 0.8) | (d_g_z1 > 0.2)):
        loss_d.backward()
        opt_d.step()

    opt_g.zero_grad(set_to_none=True)
    logits, fake_feats = d(fake, fake_labels, train=True, features=True,
                           mask=mask)
    with torch.no_grad():
        _, real_feats = d(real, real_labels, train=True, features=True,
                          mask=mask)
    adv = bce_with_logits(logits, real_targets, mask)
    perc = perceptual_loss(vgg, fake, real, mask)
    fm = feature_matching_loss(real_feats, fake_feats, mask)
    loss_g = adv + PERCEPTUAL_WEIGHT * perc + FM_WEIGHT * fm
    loss_g.backward(inputs=list(g.parameters()))
    opt_g.step()

    with torch.no_grad():
        d_g_z2 = weighted_mean(torch.sigmoid(logits), mask)
        return torch.stack([loss_g, loss_d, d_x, d_g_z1, d_g_z2, perc,
                            fm]).detach()
