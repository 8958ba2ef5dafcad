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
"""
from __future__ import annotations

import torch

from xgan_torch.data.pipeline import gather_preprocess
from xgan_torch.kernels.convt import convt4x4s2_fused
from xgan_torch.ops.reduce import weighted_mean
from xgan_torch.train.common import bce_with_logits

REAL_LABEL = 0.9  # one-sided label smoothing (reference train_gan.py:92)
FAKE_LABEL = 0.0


def dcgan_step(g, d, opt_g, opt_d, store_u8, idx, *, latent_dim: int,
               dtype: torch.dtype = torch.float32, mask=None, noise=None,
               flip=None, generator: torch.Generator | None = None,
               convt=convt4x4s2_fused) -> torch.Tensor:
    """One iteration; returns the (5,) device tensor ``[loss_G, loss_D,
    D_x, D_G_z1, D_G_z2]`` without a host sync.

    ``store_u8`` (N,S,S,3) uint8 and ``idx`` (B,) int64 live on the
    device. The flip mask and the (B, latent) noise are drawn from
    ``generator`` on the device (flip first) unless injected. ``convt``:
    the forward of G's k4s2 layers (the kernel; a check passes its plain
    version)."""
    real = gather_preprocess(store_u8, idx, flip=flip, generator=generator,
                             dtype=dtype)
    if noise is None:
        noise = torch.randn((idx.shape[0], latent_dim), generator=generator,
                            device=store_u8.device)
    fake = g.forward_train(noise, mask, convt=convt)

    opt_d.zero_grad(set_to_none=True)
    logits_real = d(real, train=True, mask=mask)
    logits_fake = d(fake.detach(), train=True, mask=mask)
    loss_d = (bce_with_logits(logits_real, REAL_LABEL, mask)
              + bce_with_logits(logits_fake, FAKE_LABEL, mask))
    loss_d.backward()
    opt_d.step()

    opt_g.zero_grad(set_to_none=True)
    logits_g = d(fake, train=True, mask=mask)
    loss_g = bce_with_logits(logits_g, REAL_LABEL, mask)
    loss_g.backward(inputs=list(g.parameters()))
    opt_g.step()

    with torch.no_grad():
        probs = [weighted_mean(torch.sigmoid(lg), mask)
                 for lg in (logits_real, logits_fake, logits_g)]
        return torch.stack([loss_g, loss_d, *probs]).detach()
