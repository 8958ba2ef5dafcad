"""One WGAN-GP train step (role of xgan/train/wgan.py, ``step_plain``).

The reference iteration, in its order:

1. the real batch gathered, flipped and normalized once on the device;
2. ``critic_iters`` critic updates on that one real batch, each with fresh
   noise and a fresh interpolation weight α:

   - G's forward in train mode under ``no_grad`` (so G's BN running
     statistics advance once per critic update, as the reference's
     ``netG(noise)`` inside its critic loop does);
   - the critic on the real batch, on the fake batch and on the
     interpolated batch, three BN batches in that order;
   - the loss ``-wmean(D(real)) + wmean(D(fake)) + gp`` and the critic's
     Adam step;

3. one G update: the critic (already updated) on ``G(z)`` in train mode,
   ``-wmean(D(G(z)))``, whose backward takes G's parameters only
   (``backward(inputs=...)``), and G's Adam step.

So per step G's BN statistics advance ``critic_iters + 1`` times and the
critic's ``3 * critic_iters + 1`` times. A (B,) ``mask`` of a padded tail
batch enters every BN statistic, every loss mean and the penalty. Losses
stay on the device.

The penalty is a double backward: ``torch.autograd.grad(..., create_graph=
True)`` through the critic (cuDNN convolutions, BN, LeakyReLU), then the
loss's backward through that graph. The fake batch is made under
``no_grad``, so no ConvT of G is on that graph: the ConvT kernel's
training form is only ever differentiated once.
"""
from __future__ import annotations

import torch

from xgan_torch.data.pipeline import gather_preprocess
from xgan_torch.kernels.convt import convt4x4s2_fused
from xgan_torch.ops.reduce import weighted_mean


def gradient_penalty(critic, real: torch.Tensor, fake: torch.Tensor,
                     alpha: torch.Tensor, lambda_gp: float = 10.0,
                     mask=None) -> torch.Tensor:
    """``lambda_gp * wmean((‖∇_x critic(x̂)‖₂ − 1)², mask)`` with
    ``x̂ = α·real + (1−α)·fake`` in f32 (the JAX promotion of an f32 α and
    fake with a bf16 real; the critic casts x̂ to its compute dtype).

    ``critic(x, train=True, mask=mask)`` runs in train mode: its BN
    running statistics advance on x̂. ``alpha``: (B, 1, 1, 1) f32. The
    gradient keeps its graph (``create_graph=True``), so the result is
    differentiable in the critic's parameters. Masked rows' scores are
    zeroed before the sum that is differentiated: their normalized
    activations depend on the valid rows' statistics, so they would leak
    gradient into the valid rows. The norm is ``sqrt(sum(g²) + 1e-12)``
    in f32."""
    b = real.shape[0]
    inter = (alpha * real + (1.0 - alpha) * fake).float().requires_grad_()
    scores = critic(inter, train=True, mask=mask)
    if mask is not None:
        scores = scores * mask.to(scores.dtype)
    grads, = torch.autograd.grad(scores.sum(), inter, create_graph=True)
    norms = torch.sqrt(grads.float().reshape(b, -1).square().sum(dim=1)
                       + 1e-12)
    return lambda_gp * weighted_mean((norms - 1.0).square(), mask)


def wgan_step(g, c, opt_g, opt_c, store_u8, idx, *, latent_dim: int,
              critic_iters: int, lambda_gp: float,
              dtype: torch.dtype = torch.float32, mask=None, flip=None,
              noises=None, alphas=None, g_noise=None,
              generator: torch.Generator | None = None,
              convt=convt4x4s2_fused) -> torch.Tensor:
    """One iteration; returns the ``(critic_iters + 1,)`` device tensor
    ``[d_loss_1, ..., d_loss_n, g_loss]`` without a host sync.

    ``store_u8`` (N,S,S,3) uint8 and ``idx`` (B,) int64 live on the
    device. The draws, unless injected, come from ``generator`` on the
    device in this order: the flip mask; for each critic update its
    (B, latent) noise and its (B, 1, 1, 1) α (``noises`` and ``alphas``:
    ``critic_iters`` of each); then G's (B, latent) noise (``g_noise``).
    ``convt``: the forward of G's k4s2 layers (the kernel; a check passes
    its plain version)."""
    dev = store_u8.device
    b = idx.shape[0]
    real = gather_preprocess(store_u8, idx, flip=flip, generator=generator,
                             dtype=dtype)
    c_params = list(c.parameters())
    losses = []
    for i in range(critic_iters):
        noise = noises[i] if noises is not None else torch.randn(
            (b, latent_dim), generator=generator, device=dev)
        alpha = alphas[i] if alphas is not None else torch.rand(
            (b, 1, 1, 1), generator=generator, device=dev)
        with torch.no_grad():
            fake = g.forward_train(noise, mask, convt=convt)
        opt_c.zero_grad(set_to_none=True)
        d_real = c(real, train=True, mask=mask)
        d_fake = c(fake, train=True, mask=mask)
        gp = gradient_penalty(c, real, fake, alpha, lambda_gp, mask)
        loss = -weighted_mean(d_real, mask) + weighted_mean(d_fake, mask) + gp
        loss.backward(inputs=c_params)
        opt_c.step()
        losses.append(loss.detach())

    if g_noise is None:
        g_noise = torch.randn((b, latent_dim), generator=generator,
                              device=dev)
    opt_g.zero_grad(set_to_none=True)
    scores = c(g.forward_train(g_noise, mask, convt=convt), train=True,
               mask=mask)
    loss_g = -weighted_mean(scores, mask)
    loss_g.backward(inputs=list(g.parameters()))
    opt_g.step()
    losses.append(loss_g.detach())
    return torch.stack(losses)
