"""One DCGAN train step (role of xgan/train/gan.py, ``step_plain``).

The reference iteration, in its order:

1. the real batch gathered, flipped and normalized on the device, and one
   generator forward in train mode, kept for the generator's backward;
2. D on the real batch (label 0.9, one-sided smoothing) and on
   ``fake.detach()`` (label 0.0), two separate BN batches;
3. the D Adam step;
4. D on ``fake`` through the *updated* D for the G loss (label 0.9); the
   backward takes gradients for G's parameters only (``backward(inputs=
   ...)``), so no D weight gradient is computed or left in ``.grad`` (the
   JAX package differentiates that pass with respect to ``fake`` alone);
5. the G Adam step.

D's BN running statistics advance three times per step and G's once. A
(B,) ``mask`` of a padded tail batch enters every BN batch statistic and
every loss and metric mean. Metrics stay on the device.

``grad_accum=A > 1`` (``step_accum`` of the JAX package) runs each update
as A sequential microbatches of B/A rows, with the draws of A = 1 (flip,
then noise, over the full batch) sliced:

1. a D phase per microbatch: G's forward under ``no_grad`` (G's running
   statistics advance once per microbatch), D on the real and the fake
   rows, and the backward of the valid-row loss *sum*; then the summed
   gradients are divided by the batch's valid-row total and D takes one
   Adam step;
2. a G phase through the updated D per microbatch: G's forward is
   recomputed (batch statistics make it the D phase's fake) without
   advancing G's running statistics again, D's advance (train mode), and
   the loss sum's backward reaches G's parameters; then one G Adam step.

Only one microbatch's activations are alive at a time: the D phase's
fakes are not kept for the G phase. A microbatch whose rows are all
padding (a tail batch) is skipped: its BN statistics stay frozen and it
adds a zero gradient, as the JAX package's select does.

Across data-parallel ranks (``mesh``, a joined process group; G's and
D's BN tied to it by ``sync_batch_norm``) every rank draws the global
batch's flip and (B, latent) noise from the same seed and takes its rows
(``MeshContext.local_rows``); D on the real rows and D on the fake rows
each form their global BN batch, both BCE means take global
denominators, the gradients are summed over the ranks before each Adam
step, and the (5,) metrics are global. Every rank's Adam so sees the
same gradients, and the parameters stay bitwise equal across ranks.
With ``grad_accum=A`` a rank holds its share of each microbatch
(``MeshContext.local_rows(B, A)``, as the JAX package row-shards every
microbatch over ``data``): each microbatch is one global BN batch, the
weight and the skipped microbatches are the global batch's, and the
gradients are summed over the ranks once per update.

Under ``--model-parallel`` ``mesh`` is the data group of the ``(data,
model)`` layout: the ranks of one model group take the same rows, noise
and flips, compute G and D column-parallel
(:mod:`xgan_torch.parallel.tp`; G's sliced k4s2 layers run the kernel on
their slice of Cout) and count their shared loss once; the replicated
parameters' gradients are broadcast over the model group after the data
group's sum (``all_reduce_grads``).

Each phase of the step is a span (:func:`xgan_torch.utils.timer.span`,
a no-op unless a profiler window is open): ``step`` holds ``data``,
``g_forward``, ``d_forward``, ``d_backward``, ``adam_d``,
``g_loss_forward``, ``g_backward`` (split where the backward reaches
``fake`` into ``d_input_grad`` and ``g_param_grad``), ``adam_g`` and
``metrics``; ``all_reduce_grads`` adds ``dp_sync``.
"""
from __future__ import annotations

import torch

from xgan_torch.data.pipeline import gather_preprocess, take_rows
from xgan_torch.kernels.convt import convt4x4s2_fused
from xgan_torch.ops.reduce import weighted_mean
from xgan_torch.parallel.mesh import all_reduce_grads
from xgan_torch.train.common import bce_sum, bce_with_logits, \
    guarded_sum, microbatches, zeroed_grads
from xgan_torch.utils.timer import span

REAL_LABEL = 0.9  # one-sided label smoothing (reference train_gan.py:92)
FAKE_LABEL = 0.0


def dcgan_step(g, d, opt_g, opt_d, store_u8, idx, *, latent_dim: int,
               dtype: torch.dtype = torch.float32, mask=None, noise=None,
               flip=None, generator: torch.Generator | None = None,
               convt=convt4x4s2_fused, grad_accum: int = 1,
               take=take_rows, mesh=None) -> torch.Tensor:
    """One iteration; returns the (5,) device tensor ``[loss_G, loss_D,
    D_x, D_G_z1, D_G_z2]``, without a host sync unless ``grad_accum > 1``
    and a ``mask`` is given (it then reads which microbatches hold valid
    rows).

    ``store_u8`` (N,S,S,3) uint8 and ``idx`` (B,) int64 live on the
    device. The flip mask and the (B, latent) noise are drawn from
    ``generator`` on the device (flip first) unless injected. ``convt``:
    the forward of G's k4s2 layers (the kernel; a check passes its plain
    version). ``grad_accum``: microbatches per update (it must divide
    B). ``take``: the store's gather (``DeviceStore.take``); ``mesh``:
    the step of one data-parallel rank (see the module docstring)."""
    with span("step"):
        dp = mesh is not None and mesh.distributed
        b = idx.shape[0]
        rows = mesh.local_rows(b, grad_accum) if dp else slice(None)
        with span("data"):
            real = gather_preprocess(store_u8, idx, flip=flip,
                                     generator=generator, dtype=dtype,
                                     take=take, rows=rows)
            if noise is None:
                noise = torch.randn((b, latent_dim), generator=generator,
                                    device=store_u8.device)
            noise = noise[rows]
            if mask is not None:
                mask = mask[rows]
        if grad_accum > 1:
            metrics = _step_accum(g, d, opt_g, opt_d, real, noise, mask,
                                  convt, b, grad_accum, mesh)
            if dp:
                with span("metrics"):
                    metrics = mesh.all_reduce_(metrics)
            return metrics
        with span("g_forward"):
            fake = g.forward_train(noise, mask, convt=convt)

        opt_d.zero_grad(set_to_none=True)
        with span("d_forward"):
            logits_real = d(real, train=True, mask=mask)
            logits_fake = d(fake.detach(), train=True, mask=mask)
            loss_d = (bce_with_logits(logits_real, REAL_LABEL, mask, mesh)
                      + bce_with_logits(logits_fake, FAKE_LABEL, mask, mesh))
        with span("d_backward"):
            loss_d.backward()
        all_reduce_grads(d.parameters(), mesh)
        with span("adam_d"):
            opt_d.step()

        opt_g.zero_grad(set_to_none=True)
        with span("g_loss_forward"):
            logits_g = d(fake, train=True, mask=mask)
            loss_g = bce_with_logits(logits_g, REAL_LABEL, mask, mesh)
        with span("g_backward") as sp:
            sp.split_at_grad(fake, "d_input_grad", "g_param_grad")
            loss_g.backward(inputs=list(g.parameters()))
        all_reduce_grads(g.parameters(), mesh)
        with span("adam_g"):
            opt_g.step()

        with span("metrics"), torch.no_grad():
            probs = [weighted_mean(torch.sigmoid(lg), mask, mesh)
                     for lg in (logits_real, logits_fake, logits_g)]
            metrics = torch.stack([loss_g, loss_d, *probs]).detach()
            return mesh.all_reduce_(metrics) if dp else metrics


def _step_accum(g, d, opt_g, opt_d, real, noise, mask, convt, b: int,
                accum: int, mesh) -> torch.Tensor:
    """``dcgan_step`` with ``grad_accum=accum`` over this rank's rows of
    the global batch of ``b``; see the module docstring. Returns this
    rank's share of the metrics."""
    w_total, micro = microbatches(mask, b, accum, mesh)
    d_params, g_params = list(d.parameters()), list(g.parameters())
    zero = real.new_zeros((), dtype=torch.float32)
    ds = dxs = dgz1s = zero
    d_grads = zeroed_grads(d_params)
    for rows, mask_mb in micro:
        with span("g_forward"), torch.no_grad():
            fake = g.forward_train(rows(noise), mask_mb, convt=convt)
        with span("d_forward"):
            logits_real = d(rows(real), train=True, mask=mask_mb)
            logits_fake = d(fake, train=True, mask=mask_mb)
            s = (bce_sum(logits_real, REAL_LABEL, mask_mb)
                 + bce_sum(logits_fake, FAKE_LABEL, mask_mb))
        with span("d_backward"):
            s.backward()
        with span("metrics"), torch.no_grad():
            ds = ds + s
            dxs = dxs + guarded_sum(torch.sigmoid(logits_real.float()),
                                     mask_mb)
            dgz1s = dgz1s + guarded_sum(torch.sigmoid(logits_fake.float()),
                                         mask_mb)
    torch._foreach_div_(d_grads, w_total)
    all_reduce_grads(d_params, mesh)
    with span("adam_d"):
        opt_d.step()

    gs = dgz2s = zero
    g_grads = zeroed_grads(g_params)
    for rows, mask_mb in micro:
        with span("g_forward"):
            fake = g.forward_train(rows(noise), mask_mb, convt=convt,
                                   update_stats=False)
        with span("g_loss_forward"):
            logits = d(fake, train=True, mask=mask_mb)
            s = bce_sum(logits, REAL_LABEL, mask_mb)
        with span("g_backward") as sp:
            sp.split_at_grad(fake, "d_input_grad", "g_param_grad")
            s.backward(inputs=g_params)
        with span("metrics"), torch.no_grad():
            gs = gs + s
            dgz2s = dgz2s + guarded_sum(torch.sigmoid(logits.float()),
                                         mask_mb)
    torch._foreach_div_(g_grads, w_total)
    all_reduce_grads(g_params, mesh)
    with span("adam_g"):
        opt_g.step()
    with span("metrics"):
        return torch.stack([gs, ds, dxs, dgz1s, dgz2s]).detach() / w_total
