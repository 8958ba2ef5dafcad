"""Weight-only int8 quantization for serving artifacts (role of
xgan/io_/quant.py).

Every conv, conv-transpose and dense weight of ndim >= 2 is stored as
per-output-channel symmetric int8: ``s = max(absmax, 1e-12) / 127`` over
the non-output axes and ``q = clip(rint(w / s), -127, 127)``. BN
parameters and statistics, biases and embeddings stay full precision.
The int8 tensors are what an exported artifact keeps; the program
dequantizes them on every call (:mod:`xgan_torch.io_.export`), as the
JAX package's does inside its traced function.

The output axis is where the layout puts it: dim 0 for ``nn.Conv2d``
``(O, I, kh, kw)`` and ``nn.Linear`` ``(O, I)``, dim 1 for
``nn.ConvTranspose2d`` ``(I, O, kh, kw)`` (flax keeps it last). So a
quantized leaf is ``{"q8": int8, "q8_scale": f32}`` with the scale shaped
to broadcast over its weight (``(O, 1, 1, 1)``, ``(1, O, 1, 1)`` or
``(O, 1)``): its values are the JAX package's ``(O,)`` scales, and ``q8``
is the JAX package's after the layout map.
"""
from __future__ import annotations

import torch
from torch import nn

_QKEYS = frozenset({"q8", "q8_scale"})
_OUT_DIM = {nn.Conv2d: 0, nn.Linear: 0, nn.ConvTranspose2d: 1}


def _is_qleaf(v) -> bool:
    return isinstance(v, dict) and set(v.keys()) == _QKEYS


def quantize_weight(w: torch.Tensor, out_dim: int) -> dict:
    """One weight -> ``{"q8", "q8_scale"}`` with per-``out_dim`` scales."""
    w = w.detach().float()
    dims = tuple(d for d in range(w.dim()) if d != out_dim)
    s = w.abs().amax(dim=dims, keepdim=True).clamp_min(1e-12) / 127.0
    q8 = torch.clamp(torch.round(w / s), -127, 127).to(torch.int8)
    return {"q8": q8, "q8_scale": s}


def quantize_params(model: nn.Module) -> dict:
    """``model``'s parameters {name: tensor}, with each conv,
    conv-transpose and dense weight of ndim >= 2 replaced by its int8
    leaf."""
    out = {name: p.detach() for name, p in model.named_parameters()}
    for mod_name, mod in model.named_modules():
        out_dim = _OUT_DIM.get(type(mod))
        if out_dim is not None and mod.weight.dim() >= 2:
            name = f"{mod_name}.weight" if mod_name else "weight"
            out[name] = quantize_weight(mod.weight, out_dim)
    return out


def dequantize_params(params: dict) -> dict:
    """int8 leaves -> f32 weights; every other entry as it is (the
    identity on an unquantized dict)."""
    return {k: (v["q8"].float() * v["q8_scale"] if _is_qleaf(v) else v)
            for k, v in params.items()}


def is_quantized(params: dict) -> bool:
    return any(_is_qleaf(v) for v in params.values())
