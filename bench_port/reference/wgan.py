"""Plain float32 reference of the WGAN-GP train step (Gulrajani et al.,
arXiv:1704.00028), as the published repository trains it
(gan-enhanced-pneumonia-classifier, ``src/train_wggan.py``).

Generator: the DCGAN generator of :mod:`.dcgan` one width up (fg*16,
fg*8, fg*4, fg*2, fg, C). Critic: Conv(k4, s2, p1) -> LeakyReLU 0.2, three
Conv(k4, s2, p1) -> BN -> LeakyReLU 0.2 (widths fd ... fd*8), Conv(k =
S/32, valid) to one channel, the mean over its map: one score a row.

One step: the real batch once; ``critic_iters`` critic updates, each with
a fresh noise and a fresh α: the generator's fake (no gradient), the
critic on the real, the fake and x̂ = α·real + (1−α)·fake (three BN
batches), the penalty λ·mean((‖∇_x̂ critic(x̂)‖₂ − 1)²) with
‖g‖₂ = sqrt(Σg² + 1e-12), the loss −mean D(real) + mean D(fake) + penalty
and one Adam step; then one G update on −mean critic(G(z)). It returns the
critic's ``critic_iters`` losses, then G's.

The draws, in the program's order on the same device: the flip; per
critic update the noise, then α; then G's noise.
"""
from __future__ import annotations

import torch

from .common import Adam, Numerics, Outputs, batch_rows, changes, \
    grads_of, leaf_params, on_host, real_batch
from .dcgan import conv_leaves, conv_ladder, g_leaves, generator_forward

C_CONV = (0, 2, 5, 8, 11)
C_BN = (3, 6, 9)


def g_widths(cfg: dict) -> list[int]:
    fg = cfg["feature_maps_g"]
    return [fg * 16, fg * 8, fg * 4, fg * 2, fg]


def d_widths(cfg: dict) -> list[int]:
    fd = cfg["feature_maps_d"]
    return [fd, fd * 2, fd * 4, fd * 8]


def leaves(cfg: dict) -> dict:
    return {"g": g_leaves(cfg, g_widths(cfg)),
            "d": conv_leaves(cfg, d_widths(cfg), C_CONV, C_BN)}


def critic(p: dict, x: torch.Tensor, num: Numerics) -> torch.Tensor:
    return conv_ladder(p, x, num, C_CONV, C_BN).mean(dim=(1, 2, 3))


def run(cfg: dict, cell: dict, store: torch.Tensor, order: torch.Tensor,
        draw_seed: int, weights: dict, n_steps: int,
        precision: str = "f32", fault: str | None = None) -> Outputs:
    """Follow the program's first ``n_steps`` steps from ``weights`` on
    batches ``order[0..n_steps)``."""
    num = Numerics(precision)
    dev = store.device
    b, latent = cell["batch"], cfg["latent_dim"]
    n, lam = cfg["critic_iters"], cfg["lambda_gp"]
    gp, cp = leaf_params(weights["g"]), leaf_params(weights["d"])
    opt_g = Adam(gp, cfg["lr"], cfg["beta1"], cfg["beta2"])
    opt_c = Adam(cp, cfg["lr"], cfg["beta1"], cfg["beta2"])
    draws = torch.Generator(dev).manual_seed(draw_seed)
    rows = batch_rows(b, fault)
    metrics, first = [], {}
    for t in range(n_steps):
        flip = torch.rand((b,), generator=draws, device=dev) < 0.5
        per_update = [(torch.randn((b, latent), generator=draws, device=dev),
                       torch.rand((b, 1, 1, 1), generator=draws, device=dev))
                      for _ in range(n)]
        g_noise = torch.randn((b, latent), generator=draws, device=dev)
        real = real_batch(store, order[t][rows], flip[rows])
        losses = []
        for u, (noise, alpha) in enumerate(per_update):
            with torch.no_grad():
                fake = generator_forward(gp, noise[rows], num)
            d_real = critic(cp, real, num)
            d_fake = critic(cp, fake, num)
            a = alpha[rows]
            inter = (a * real + (1.0 - a) * fake).requires_grad_()
            grad_x, = torch.autograd.grad(critic(cp, inter, num).sum(), inter,
                                          create_graph=True)
            norm = torch.sqrt(grad_x.reshape(grad_x.shape[0], -1).square()
                              .sum(dim=1) + 1e-12)
            penalty = lam * (norm - 1.0).square().mean()
            loss = -d_real.mean() + d_fake.mean() + penalty
            gc = grads_of(loss, cp)
            opt_c.step(gc)
            if t == 0 and u == 0:
                first["d"] = on_host(gc)
            losses.append(float(loss.detach()))
        loss_g = -critic(cp, generator_forward(gp, g_noise[rows], num),
                         num).mean()
        gg = grads_of(loss_g, gp)
        opt_g.step(gg)
        if t == 0:
            first["g"] = on_host(gg)
        metrics.append(losses + [float(loss_g.detach())])
    return Outputs(metrics, first, {"g": changes(gp, weights["g"]),
                                    "d": changes(cp, weights["d"])})
