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

Across data-parallel ranks (``mesh``, a joined process group; G's and
the critic's BN tied to it by ``sync_batch_norm``) every rank draws the
global batch's flip, noises, α and G's noise from the same seed and takes
its rows (``MeshContext.local_rows``), so N ranks compute the function of
one. Every BN batch (G's, the critic's real, fake and x̂) is global, the
loss means and the penalty's mean take global denominators, the
gradients are summed over the ranks before each Adam step and the losses
are global. The penalty's double backward crosses the ranks through BN's
differentiable all-reduce, which every rank issues in the same order.
With ``grad_accum`` a rank holds its share of each microbatch, as in
:mod:`xgan_torch.train.gan`.

Under ``--model-parallel`` ``mesh`` is the data group of the ``(data,
model)`` layout: the ranks of one model group take the same rows and
draws, compute G and the critic column-parallel
(:mod:`xgan_torch.models.wgan`; G's sliced k4s2 layers run the kernel on
their slice of Cout) and count their shared losses once. The penalty's
double backward crosses the model group's all-reduces and gathers as
well as BN's data-group all-reduce (:func:`gradient_penalty`), on the
calling thread alone (``one_autograd_thread``), so that every rank of
the group issues them in one order. After each of the ``critic_iters``
critic updates and after the G update, ``all_reduce_grads`` sums the
gradients over the data group and broadcasts the replicated
parameters' over the model group.
"""
from __future__ import annotations

import torch

from xgan_torch.data.pipeline import gather_preprocess, take_rows
from xgan_torch.kernels.convt import convt4x4s2_fused
from xgan_torch.ops.reduce import at_least_f32, weighted_mean
from xgan_torch.parallel.mesh import all_reduce_grads
from xgan_torch.parallel.tp import one_autograd_thread
from xgan_torch.train.common import guarded_sum, microbatches, \
    zeroed_grads


def gradient_penalty(critic, real: torch.Tensor, fake: torch.Tensor,
                     alpha: torch.Tensor, lambda_gp: float = 10.0,
                     mask=None, mesh=None) -> torch.Tensor:
    """``lambda_gp * wmean((‖∇_x critic(x̂)‖₂ − 1)², mask)`` with
    ``x̂ = α·real + (1−α)·fake`` in f32 (the JAX promotion of an f32 α and
    fake with a bf16 real; the critic casts x̂ to its compute dtype), or
    float64 where the inputs are (a check's).

    ``critic(x, train=True, mask=mask)`` runs in train mode: its BN
    running statistics advance on x̂. ``alpha``: (B, 1, 1, 1) f32. The
    gradient keeps its graph (``create_graph=True``), so the result is
    differentiable in the critic's parameters. Masked rows' scores are
    zeroed before the sum that is differentiated: their normalized
    activations depend on the valid rows' statistics, so they would leak
    gradient into the valid rows. The norm is ``sqrt(sum(g²) + 1e-12)``
    in f32 (at least).

    ``mesh`` (a joined process group; the critic's BN tied to it): the
    rows are this rank's, and the result is this rank's share of the
    global penalty mean. The differentiated sum stays this rank's: the
    other ranks' scores reach its rows through BN's cross-rank statistics,
    whose all-reduce backward sums their gradients, and that backward is
    differentiable in turn (``all_reduce_sum``).

    Under tensor parallelism (a critic placed over ``mesh.model``) ``x̂``
    is the same on every rank of the model group, and so are its scores
    (the head gathers); the input gradient is whole on each of them
    (each column-parallel conv's input is marked by ``copy_to_model``,
    whose backward sums the ranks' partial input gradients), so the
    penalty is one process's on every rank of the group and counts once.
    Its backward differentiates those all-reduces and gathers again: each
    operator's backward is made of the others. The input gradient is
    taken, and the caller's backward through it must be run, under
    :func:`~xgan_torch.parallel.tp.one_autograd_thread`, so that the
    ranks of the group issue those collectives in one order whatever
    autograd work each ran before."""
    b = real.shape[0]
    inter = at_least_f32(alpha * real + (1.0 - alpha) * fake) \
        .requires_grad_()
    scores = critic(inter, train=True, mask=mask)
    if mask is not None:
        scores = scores * mask.to(scores.dtype)
    with one_autograd_thread(critic):
        grads, = torch.autograd.grad(scores.sum(), inter, create_graph=True)
    norms = torch.sqrt(at_least_f32(grads).reshape(b, -1).square().sum(dim=1)
                       + 1e-12)
    return lambda_gp * weighted_mean((norms - 1.0).square(), mask, mesh)


def wgan_step(g, c, opt_g, opt_c, store_u8, idx, *, latent_dim: int,
              critic_iters: int, lambda_gp: float,
              dtype: torch.dtype = torch.float32, mask=None, flip=None,
              noises=None, alphas=None, g_noise=None,
              generator: torch.Generator | None = None,
              convt=convt4x4s2_fused, grad_accum: int = 1,
              take=take_rows, mesh=None) -> torch.Tensor:
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
    divide B). ``take``: the store's gather (``DeviceStore.take``);
    ``mesh``: the step of one data-parallel rank (see the module
    docstring)."""
    dev = store_u8.device
    dp = mesh is not None and mesh.distributed
    b = idx.shape[0]
    rows = mesh.local_rows(b, grad_accum) if dp else slice(None)
    real = gather_preprocess(store_u8, idx, flip=flip, generator=generator,
                             dtype=dtype, take=take, rows=rows)
    draws = [((noises[i] if noises is not None else torch.randn(
                   (b, latent_dim), generator=generator, device=dev))[rows],
              (alphas[i] if alphas is not None else torch.rand(
                   (b, 1, 1, 1), generator=generator, device=dev))[rows])
             for i in range(critic_iters)]
    if g_noise is None:
        g_noise = torch.randn((b, latent_dim), generator=generator,
                              device=dev)
    g_noise = g_noise[rows]
    if mask is not None:
        mask = mask[rows]
    if grad_accum > 1:
        losses = _step_accum(g, c, opt_g, opt_c, real, draws, g_noise, mask,
                             lambda_gp, b, grad_accum, convt, mesh)
        return mesh.all_reduce_(losses) if dp else losses
    c_params = list(c.parameters())
    losses = []
    for noise, alpha in draws:
        with torch.no_grad():
            fake = g.forward_train(noise, mask, convt=convt)
        opt_c.zero_grad(set_to_none=True)
        d_real = c(real, train=True, mask=mask)
        d_fake = c(fake, train=True, mask=mask)
        gp = gradient_penalty(c, real, fake, alpha, lambda_gp, mask, mesh)
        loss = (-weighted_mean(d_real, mask, mesh)
                + weighted_mean(d_fake, mask, mesh) + gp)
        with one_autograd_thread(c):
            loss.backward(inputs=c_params)
        all_reduce_grads(c_params, mesh)
        opt_c.step()
        losses.append(loss.detach())

    opt_g.zero_grad(set_to_none=True)
    g_params = list(g.parameters())
    scores = c(g.forward_train(g_noise, mask, convt=convt), train=True,
               mask=mask)
    loss_g = -weighted_mean(scores, mask, mesh)
    loss_g.backward(inputs=g_params)
    all_reduce_grads(g_params, mesh)
    opt_g.step()
    losses.append(loss_g.detach())
    losses = torch.stack(losses)
    return mesh.all_reduce_(losses) if dp else losses


def _step_accum(g, c, opt_g, opt_c, real, draws, g_noise, mask, lambda_gp,
                b: int, accum: int, convt, mesh) -> torch.Tensor:
    """``wgan_step`` with ``grad_accum=accum`` over this rank's rows of
    the global batch of ``b``; see the module docstring. Returns this
    rank's share of the losses."""
    w_total, micro = microbatches(mask, b, accum, mesh)
    losses = [_critic_update_accum(g, c, opt_c, real, noise, alpha,
                                   lambda_gp, micro, w_total, convt, mesh)
              for noise, alpha in draws]
    losses.append(_g_update_accum(g, c, opt_g, g_noise, micro, w_total,
                                  convt, mesh))
    return torch.stack(losses)


def _critic_update_accum(g, c, opt_c, real, noise, alpha, lambda_gp, micro,
                         w_total: float, convt, mesh) -> torch.Tensor:
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
                              mask_mb, mesh)
        # gp: (this rank's share of) the microbatch's mean penalty; times
        # the microbatch's valid rows over every rank, (this rank's part
        # of) their sum. Without a mask every microbatch is whole.
        if mask_mb is None:
            w_mb = w_total / len(micro)
        else:
            w_mb = mask_mb.float().sum()
            if mesh is not None and mesh.distributed:
                w_mb = mesh.all_reduce_(w_mb)
        s = guarded_sum(d_fake.float() - d_real.float(), mask_mb) + gp * w_mb
        with one_autograd_thread(c):
            s.backward(inputs=c_params)
        total = total + s.detach()
    torch._foreach_div_(grads, w_total)
    all_reduce_grads(c_params, mesh)
    opt_c.step()
    return total / w_total


def _g_update_accum(g, c, opt_g, g_noise, micro, w_total: float,
                    convt, mesh) -> torch.Tensor:
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
    all_reduce_grads(g_params, mesh)
    opt_g.step()
    return total / w_total
