"""All-pairs SSIM on the device (role of xgan/ops/ssim.py).

The math of ``skimage.metrics.structural_similarity``'s defaults for 2-D
float images, as the JAX package has it: a valid 7x7 uniform mean, K1 =
0.01, K2 = 0.03, the sample covariance (N / (N - 1)) and a mean over the
cropped window. Everything runs in f32 through plain torch ops: XLA does
this in the JAX package, with no Pallas kernel.

The 7x7 mean is ``F.avg_pool2d`` (a sum of 49 f32 values over 49), not a
convolution: on CUDA, cuDNN would run ``F.conv2d`` in TF32 by default,
which costs ~1e-3. The first images are taken in chunks so that the
(chunk, Nb, H, W) products stay near ``PAIR_BUDGET`` images of memory.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

WIN = 7
K1, K2 = 0.01, 0.03
PAIR_BUDGET = 512  # images of H x W f32 in one chunk's products


def _uniform_filter(x: torch.Tensor) -> torch.Tensor:
    """Valid-window 7x7 mean over the last two dims of (..., H, W)."""
    lead = x.shape[:-2]
    y = F.avg_pool2d(x.reshape((-1, 1) + x.shape[-2:]), WIN, stride=1)
    return y.reshape(lead + y.shape[-2:])


def ssim_pair_matrix(a: torch.Tensor, b: torch.Tensor,
                     data_range: float = 1.0) -> torch.Tensor:
    """(Na, H, W) x (Nb, H, W) float images -> (Na, Nb) f32 mean-SSIM
    matrix."""
    a, b = a.float(), b.float()
    npix = WIN * WIN
    cov_norm = npix / (npix - 1)
    c1 = (K1 * data_range) ** 2
    c2 = (K2 * data_range) ** 2
    mu_b = _uniform_filter(b)                            # (Nb, h, w)
    var_b = cov_norm * (_uniform_filter(b * b) - mu_b * mu_b)
    chunk = max(1, PAIR_BUDGET // max(1, b.shape[0]))
    rows = []
    for ai in torch.split(a, chunk):
        mu_a = _uniform_filter(ai)[:, None]              # (c, 1, h, w)
        var_a = cov_norm * (_uniform_filter(ai * ai)[:, None] - mu_a * mu_a)
        mu_ab = _uniform_filter(ai[:, None] * b[None])   # (c, Nb, h, w)
        cov = cov_norm * (mu_ab - mu_a * mu_b)
        num = (2 * mu_a * mu_b + c1) * (2 * cov + c2)
        den = (mu_a ** 2 + mu_b ** 2 + c1) * (var_a + var_b + c2)
        rows.append(torch.mean(num / den, dim=(-2, -1)))
    return torch.cat(rows)


def mean_ssim_per_synthetic(synth: torch.Tensor,
                            real: torch.Tensor) -> torch.Tensor:
    """Mean SSIM of each synthetic image against all real references
    (the reference's avg_ssim_scores, analyze_results.py:414-420)."""
    return ssim_pair_matrix(synth, real).mean(dim=1)
