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

``grad_accum=A > 1`` (``step_accum`` of the JAX package) runs every
critic update and the G update as A sequential microbatches of B/A rows,
with A = 1's draws (the flip; per critic update the noise and α; G's
noise, each over the full batch) sliced. Per microbatch: G's forward,
the critic's three BN batches and the penalty (its mean over the
microbatch's valid rows, times their count, enters the loss sum); the
backward of the valid-row loss *sum* accumulates into ``.grad``; BN
statistics advance per microbatch. The summed gradients are divided by
the batch's valid-row total before each Adam step, and the losses are
the sums over that total. A microbatch whose rows are all padding (a
tail batch) is skipped: its statistics stay frozen and it adds a zero
gradient, as the JAX package's select does.

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
from xgan_torch.train.common import guarded_sum, microbatches, \
    zeroed_grads


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
              convt=convt4x4s2_fused, grad_accum: int = 1) -> torch.Tensor:
    """One iteration; returns the ``(critic_iters + 1,)`` device tensor
    ``[d_loss_1, ..., d_loss_n, g_loss]``, without a host sync unless
    ``grad_accum > 1`` and a ``mask`` is given (it then reads which
    microbatches hold valid rows).

    ``store_u8`` (N,S,S,3) uint8 and ``idx`` (B,) int64 live on the
    device. The draws, unless injected, come from ``generator`` on the
    device in this order: the flip mask; for each critic update its
    (B, latent) noise and its (B, 1, 1, 1) α (``noises`` and ``alphas``:
    ``critic_iters`` of each); then G's (B, latent) noise (``g_noise``).
    ``convt``: the forward of G's k4s2 layers (the kernel; a check passes
    its plain version). ``grad_accum``: microbatches per update (it must
    divide B)."""
    dev = store_u8.device
    b = idx.shape[0]
    real = gather_preprocess(store_u8, idx, flip=flip, generator=generator,
                             dtype=dtype)
    draws = [(noises[i] if noises is not None else torch.randn(
                  (b, latent_dim), generator=generator, device=dev),
              alphas[i] if alphas is not None else torch.rand(
                  (b, 1, 1, 1), generator=generator, device=dev))
             for i in range(critic_iters)]
    if g_noise is None:
        g_noise = torch.randn((b, latent_dim), generator=generator,
                              device=dev)
    if grad_accum > 1:
        return _step_accum(g, c, opt_g, opt_c, real, draws, g_noise, mask,
                           lambda_gp, grad_accum, convt)
    c_params = list(c.parameters())
    losses = []
    for noise, alpha in draws:
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

    opt_g.zero_grad(set_to_none=True)
    scores = c(g.forward_train(g_noise, mask, convt=convt), train=True,
               mask=mask)
    loss_g = -weighted_mean(scores, mask)
    loss_g.backward(inputs=list(g.parameters()))
    opt_g.step()
    losses.append(loss_g.detach())
    return torch.stack(losses)


def _step_accum(g, c, opt_g, opt_c, real, draws, g_noise, mask, lambda_gp,
                accum: int, convt) -> torch.Tensor:
    """``wgan_step`` with ``grad_accum=accum``; see the module
    docstring."""
    w_total, micro = microbatches(mask, real.shape[0], accum)
    losses = [_critic_update_accum(g, c, opt_c, real, noise, alpha,
                                   lambda_gp, micro, w_total, convt)
              for noise, alpha in draws]
    losses.append(_g_update_accum(g, c, opt_g, g_noise, micro, w_total,
                                  convt))
    return torch.stack(losses)


def _critic_update_accum(g, c, opt_c, real, noise, alpha, lambda_gp, micro,
                         w_total: float, convt) -> torch.Tensor:
    """One critic update of ``wgan_step(grad_accum=A)`` over ``micro``
    (:func:`~xgan_torch.train.gan.microbatches`); returns its loss."""
    c_params = list(c.parameters())
    grads = zeroed_grads(c_params)
    total = real.new_zeros((), dtype=torch.float32)
    for rows, mask_mb in micro:
        real_mb = rows(real)
        with torch.no_grad():
            fake = g.forward_train(rows(noise), mask_mb, convt=convt)
        d_real = c(real_mb, train=True, mask=mask_mb)
        d_fake = c(fake, train=True, mask=mask_mb)
        gp = gradient_penalty(c, real_mb, fake, rows(alpha), lambda_gp,
                              mask_mb)
        w_mb = real_mb.shape[0] if mask_mb is None else mask_mb.float().sum()
        s = guarded_sum(d_fake.float() - d_real.float(), mask_mb) + gp * w_mb
        s.backward(inputs=c_params)
        total = total + s.detach()
    torch._foreach_div_(grads, w_total)
    opt_c.step()
    return total / w_total


def _g_update_accum(g, c, opt_g, g_noise, micro, w_total: float,
                    convt) -> torch.Tensor:
    """The G update of ``wgan_step(grad_accum=A)``; returns its loss."""
    g_params = list(g.parameters())
    grads = zeroed_grads(g_params)
    total = g_noise.new_zeros((), dtype=torch.float32)
    for rows, mask_mb in micro:
        scores = c(g.forward_train(rows(g_noise), mask_mb, convt=convt),
                   train=True, mask=mask_mb)
        s = -guarded_sum(scores, mask_mb)
        s.backward(inputs=g_params)
        total = total + s.detach()
    torch._foreach_div_(grads, w_total)
    opt_g.step()
    return total / w_total
