"""Plain float32 reference of the DCGAN train step (Radford et al.,
arXiv:1511.06434), as the published repository trains it
(gan-enhanced-pneumonia-classifier, ``src/train_gan.py``).

Generator: z -> ConvT(k = S/32, s1, p0) -> BN -> ReLU, then four
ConvT(k4, s2, p1) -> BN -> ReLU and a last ConvT(k4, s2, p1) -> tanh,
widths fg*8, fg*4, fg*2, fg, fg//2, C. Discriminator: Conv(k4, s2, p1) ->
LeakyReLU 0.2, four Conv(k4, s2, p1) -> BN -> LeakyReLU 0.2 (widths
fd//2 ... fd*8), Conv(k = S/32, valid) to one logit. BN in train mode
throughout; no biases on the convolutions. Leaves are named as the
published ``nn.Sequential`` names them.

One step, in the published order: the real batch (rows of the store,
flipped at random, ImageNet-normalized), one generator forward; D on the
real batch (label 0.9) and on the detached fake (label 0.0), binary
cross-entropy on logits, one Adam step of D; D, updated, on the fake
(label 0.9), whose gradient reaches G's leaves only, one Adam step of G.
It returns ``[loss_G, loss_D, D(x), D(G(z1)), D(G(z2))]``, the last three
the mean sigmoid of the logits.

The draws come from a generator seeded as the program's step-draw
generator, in the program's order (the flip, then the noise), on the same
device, so that both sides see the same numbers.
"""
from __future__ import annotations

import torch

from .common import Adam, Numerics, Outputs, batch_rows, bce_logits_mean, \
    bn_train, changes, grads_of, leaf_params, on_host, real_batch

REAL_LABEL = 0.9
FAKE_LABEL = 0.0
G_CONVT = (0, 3, 6, 9, 12, 15)
G_BN = (1, 4, 7, 10, 13)
D_CONV = (0, 2, 5, 8, 11, 14)
D_BN = (3, 6, 9, 12)


def g_widths(cfg: dict) -> list[int]:
    fg = cfg["feature_maps_g"]
    return [fg * 8, fg * 4, fg * 2, fg, fg // 2]


def d_widths(cfg: dict) -> list[int]:
    fd = cfg["feature_maps_d"]
    return [fd // 2, fd, fd * 2, fd * 4, fd * 8]


def g_leaves(cfg: dict, widths: list[int]) -> list:
    c, s0 = cfg["num_channels"], cfg["image_size"] // 32
    chans = [cfg["latent_dim"]] + list(widths) + [c]
    out = []
    for i, seq in enumerate(G_CONVT):
        k = s0 if i == 0 else 4
        out.append((f"main.{seq}.weight", (chans[i], chans[i + 1], k, k),
                    "conv"))
        if i < 5:
            out.append((f"main.{seq + 1}.weight", (chans[i + 1],),
                        "bn_weight"))
            out.append((f"main.{seq + 1}.bias", (chans[i + 1],), "bn_bias"))
    return out


def conv_leaves(cfg: dict, widths: list[int], seq_conv, seq_bn) -> list:
    chans = [cfg["num_channels"]] + list(widths)
    out = []
    for i, seq in enumerate(seq_conv[:-1]):
        out.append((f"main.{seq}.weight", (chans[i + 1], chans[i], 4, 4),
                    "conv"))
        if seq + 1 in seq_bn:
            out.append((f"main.{seq + 1}.weight", (chans[i + 1],),
                        "bn_weight"))
            out.append((f"main.{seq + 1}.bias", (chans[i + 1],), "bn_bias"))
    s0 = cfg["image_size"] // 32
    out.append((f"main.{seq_conv[-1]}.weight", (1, chans[-1], s0, s0),
                "conv"))
    return out


def leaves(cfg: dict) -> dict:
    return {"g": g_leaves(cfg, g_widths(cfg)),
            "d": conv_leaves(cfg, d_widths(cfg), D_CONV, D_BN)}


def generator_forward(p: dict, z: torch.Tensor, num: Numerics) -> torch.Tensor:
    """z (B, latent) -> NCHW images in [-1, 1]."""
    x = num.convt(z[:, :, None, None], p["main.0.weight"])
    x = num.act(torch.relu(num.act(
        bn_train(x, p["main.1.weight"], p["main.1.bias"]))))
    for i, seq in enumerate(G_CONVT[1:]):
        x = num.convt(x, p[f"main.{seq}.weight"], 2, 1)
        if i < 4:
            bn = f"main.{seq + 1}"
            x = num.act(torch.relu(num.act(
                bn_train(x, p[f"{bn}.weight"], p[f"{bn}.bias"]))))
    return torch.tanh(x)


def conv_ladder(p: dict, x: torch.Tensor, num: Numerics, seq_conv,
                seq_bn) -> torch.Tensor:
    """The convolutions of a discriminator or critic: NCHW ``x`` -> the
    last (valid) convolution's NCHW output."""
    x = num.act(x)
    for seq in seq_conv[:-1]:
        x = num.conv(x, p[f"main.{seq}.weight"], 2, 1)
        if seq + 1 in seq_bn:
            bn = f"main.{seq + 1}"
            x = num.act(bn_train(x, p[f"{bn}.weight"], p[f"{bn}.bias"]))
        x = num.act(torch.nn.functional.leaky_relu(x, 0.2))
    return num.conv(x, p[f"main.{seq_conv[-1]}.weight"])


def discriminator(p: dict, x: torch.Tensor, num: Numerics) -> torch.Tensor:
    return conv_ladder(p, x, num, D_CONV, D_BN).reshape(x.shape[0])


def run(cfg: dict, cell: dict, store: torch.Tensor, order: torch.Tensor,
        draw_seed: int, weights: dict, n_steps: int,
        precision: str = "f32", fault: str | None = None) -> Outputs:
    """Follow the program's first ``n_steps`` steps from ``weights``
    (:func:`leaves`' names) on batches ``order[0..n_steps)``."""
    num = Numerics(precision)
    dev = store.device
    b, latent = cell["batch"], cfg["latent_dim"]
    gp, dp = leaf_params(weights["g"]), leaf_params(weights["d"])
    opt_g = Adam(gp, cfg["lr"], cfg["beta1"], cfg["beta2"])
    opt_d = Adam(dp, cfg["lr"], cfg["beta1"], cfg["beta2"])
    draws = torch.Generator(dev).manual_seed(draw_seed)
    rows = batch_rows(b, fault)
    metrics, first = [], {}
    for t in range(n_steps):
        flip = torch.rand((b,), generator=draws, device=dev) < 0.5
        noise = torch.randn((b, latent), generator=draws, device=dev)
        real = real_batch(store, order[t][rows], flip[rows])
        fake = generator_forward(gp, noise[rows], num)
        logits_real = discriminator(dp, real, num)
        logits_fake = discriminator(dp, fake.detach(), num)
        loss_d = (bce_logits_mean(logits_real, REAL_LABEL)
                  + bce_logits_mean(logits_fake, FAKE_LABEL))
        gd = grads_of(loss_d, dp)
        opt_d.step(gd)
        logits_g = discriminator(dp, fake, num)
        loss_g = bce_logits_mean(logits_g, REAL_LABEL)
        gg = grads_of(loss_g, gp)
        opt_g.step(gg)
        if t == 0:
            first = {"g": on_host(gg), "d": on_host(gd)}
        with torch.no_grad():
            metrics.append([float(v) for v in (
                loss_g, loss_d, torch.sigmoid(logits_real).mean(),
                torch.sigmoid(logits_fake).mean(),
                torch.sigmoid(logits_g).mean())])
    return Outputs(metrics, first, {"g": changes(gp, weights["g"]),
                                    "d": changes(dp, weights["d"])})
