"""BatchNorm with torch semantics over the channel axis
(role of xgan/ops/norm.py).

Train mode normalizes with the biased batch variance and updates the
running statistics with momentum 0.1, the running variance from the
unbiased estimate. An optional ``(B,)`` validity mask makes the statistics
those of the valid rows only: the reference DataLoader's smaller final
batch, here a wrap-padded batch of static shape. Masked rows are still
normalized (with the masked statistics); every loss masks them too. A
``(k, B)`` mask is k folds' row weights over k*C fold-major channels
(``ResNet50(folds=k)``): each fold's channels take its own rows.
Statistics and the affine are computed in float32 even when activations
are bf16 (in float64 for float64 activations, a check's); the result has
the input's dtype.

Across data-parallel ranks (``mesh``, a joined process group) the
statistics are those of the global batch, as GSPMD makes them in the JAX
package, combined by Chan's formula: each rank takes its per-channel
weighted count ``n_r``, mean ``mean_r`` and centred second moment
``M2_r = sum(w*(x - mean_r)^2)`` (a second pass over its own rows), one
differentiable all-reduce carries the three rows at the rank's slot of a
zero ``(world, 3, C)`` buffer, so the gradient reaches every rank's rows,
and every rank combines them alike: ``n = sum n_r``, ``mean = sum n_r
mean_r / n``, ``M2 = sum M2_r + sum n_r (mean_r - mean)^2``. The moments
are summed in float64 and the mean is applied as an f32 pair
(:func:`_centre`), so a channel whose mean is far above its spread keeps
the digits one process's ``F.batch_norm`` keeps (the one-pass
``s2/n - mean^2`` cancels there). A rank whose rows are all masked adds
nothing. Under tensor parallelism ``x`` holds this rank's slice of the
channels and ``mesh`` is the data group: the statistics are per channel,
so the slice's are exact, and the model group takes no part in them.
"""
from __future__ import annotations

import torch

from xgan_torch.ops.reduce import at_least_f32
from xgan_torch.parallel.mesh import all_reduce_sum


def batch_norm_train(x, scale, bias, running_mean, running_var, *,
                     dim: int = -1, momentum: float = 0.1,
                     eps: float = 1e-5, mask=None, mesh=None):
    """Train-mode BN over channel axis ``dim`` (the last for NHWC, 1 for
    NCHW). Returns ``(y, new_running_mean, new_running_var)``.

    With ``mask``, ``n = sum(mask) * H * W`` valid elements per channel;
    ``max(n, 1)`` keeps an all-zero mask from dividing by zero. A
    ``(k, B)`` mask weighs the rows of each fold's C = channels / k
    channels with its own row. ``mesh``: the
    :class:`~xgan_torch.parallel.MeshContext` whose ranks share the batch
    (the sums path, with or without a mask)."""
    x32 = at_least_f32(x)
    ct = x32.dtype
    dim = dim % x.dim()
    axes = [a for a in range(x.dim()) if a != dim]
    shape = [1] * x.dim()
    shape[dim] = -1
    dp = mesh is not None and mesh.distributed
    mean64 = None  # the float64 mean of the mesh path
    if mask is None and not dp:
        mean = x32.mean(dim=axes)
        var = x32.square().mean(dim=axes) - mean.square()
        n = torch.tensor(float(x.numel() // x.shape[dim]), device=x.device)
    else:
        w = (torch.ones(x.shape[0], device=x.device) if mask is None
             else mask.float())
        if w.dim() == 2:  # (k, B) -> (B, k*C), fold-major channels
            w = w.t().repeat_interleave(x.shape[dim] // w.shape[0], dim=1)
        else:
            w = w[:, None]
        shape_w = [1] * x.dim()
        shape_w[0], shape_w[dim] = w.shape
        w = w.reshape(shape_w)
        n = w.sum(dim=0).reshape(-1) \
            * float(x.numel() // (x.shape[0] * x.shape[dim]))
        if dp:
            # no mask: every weight is 1, so the products are skipped
            n, mean, var = _moments_across_ranks(
                x32, None if mask is None else w, n, axes, shape, mesh)
            mean64 = mean
            mean, var, n = mean.to(ct), var.to(ct), n.to(ct)
        else:
            s1 = (x32 * w).sum(dim=axes)
            s2 = (x32.square() * w).sum(dim=axes)
            denom = torch.clamp(n, min=1.0)
            mean = s1 / denom
            var = s2 / denom - mean.square()
    var = torch.clamp(var, min=0.0)
    unbiased = var * (n / torch.clamp(n - 1, min=1.0))
    new_mean = (1.0 - momentum) * running_mean + momentum * mean
    new_var = (1.0 - momentum) * running_var + momentum * unbiased
    inv = scale.to(ct) / torch.sqrt(var + eps)
    if mean64 is None:
        centred = x32 - mean.reshape(shape)
    else:
        centred = _centre(x32, mean64, shape)
    y = centred * inv.reshape(shape) + bias.to(ct).reshape(shape)
    return y.to(x.dtype), new_mean, new_var


def _centre(x: torch.Tensor, m64: torch.Tensor, shape) -> torch.Tensor:
    """``x - m64`` (``m64`` a float64 per-channel mean, viewed as
    ``shape``): for f32 ``x`` through the f32 pair ``(hi, lo)``, ``hi``
    the mean rounded to f32 and ``lo`` the f32 of the rest, ``(x - hi) -
    lo``, which centres ``x`` on the mean without that rounding (at a mean
    far above the spread it would shift every normalized value); a
    float64 ``x`` (a check's) takes the mean whole, so that no gradient
    passes through an f32 value."""
    if x.dtype == torch.float64:
        return x - m64.reshape(shape)
    hi = m64.float()
    lo = (m64 - hi.double()).float()
    return (x - hi.reshape(shape)) - lo.reshape(shape)


def _moments_across_ranks(x32, w, n_r, axes, shape, mesh):
    """Chan's combine of the ranks' per-channel moments (see the module
    docstring), ``w`` the row weights or None (all 1): returns the global
    ``(n, mean, var)`` in float64, the same on every rank and
    differentiable through one all-reduce."""
    s1 = (x32 if w is None else x32 * w).sum(dim=axes, dtype=torch.float64)
    n_r = n_r.double().expand_as(s1)
    mean_r = s1 / torch.clamp(n_r, min=1.0)
    d2 = _centre(x32, mean_r, shape).square()
    m2_r = (d2 if w is None else d2 * w).sum(dim=axes, dtype=torch.float64)
    mine = torch.stack([n_r, mean_r, m2_r])
    zero = torch.zeros_like(mine)
    n_i, mean_i, m2_i = all_reduce_sum(torch.stack(
        [mine if r == mesh.rank else zero for r in range(mesh.world)]),
        mesh).unbind(1)
    n = n_i.sum(0)
    denom = torch.clamp(n, min=1.0)
    mean = (n_i * mean_i).sum(0) / denom
    m2 = m2_i.sum(0) + (n_i * (mean_i - mean).square()).sum(0)
    return n, mean, m2 / denom


def batch_norm_infer(x, scale, bias, running_mean, running_var, *,
                     eps: float = 1e-5):
    """Eval-mode BN over the last (channel) axis using running statistics;
    the result has ``x.dtype``."""
    x32 = x.float()
    inv = scale.float() / torch.sqrt(running_var.float() + eps)
    y = (x32 - running_mean.float()) * inv + bias.float()
    return y.to(x.dtype)


def fold_bn(scale, bias, running_mean, running_var, *, eps: float = 1e-5):
    """Eval BN as a per-channel affine ``y = x * scale' + shift'`` in f32:
    ``scale' = scale / sqrt(var + eps)``, ``shift' = bias - mean * scale'``.
    Agrees with :func:`batch_norm_infer` to f32 rounding (the arithmetic
    is reordered), which lets a conv kernel apply BN in its epilogue."""
    s = scale.float() / torch.sqrt(running_var.float() + eps)
    return s, bias.float() - running_mean.float() * s
