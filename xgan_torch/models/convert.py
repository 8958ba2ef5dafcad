"""Generator checkpoint interop (role of xgan/models/pretrained.py's GAN
generator codecs).

The JAX package keeps ConvT kernels as HWIO arrays that are the spatial
flip of torch's ``(I, O, kh, kw)`` ConvTranspose2d weights; the DCGAN
generator's state dict uses the reference ``nn.Sequential`` indices
(``xgan_torch.models.dcgan.SEQ_CONVT`` / ``SEQ_BN``).
"""
from __future__ import annotations

import numpy as np
import torch

from xgan_torch.models.dcgan import SEQ_BN, SEQ_CONVT


def convt_hwio_to_torch(w) -> np.ndarray:
    """JAX-package HWIO ConvT kernel -> torch (I, O, kh, kw), flipping
    kh and kw. ``.copy()``: the flip leaves negative strides."""
    return np.transpose(np.asarray(w, np.float32)[::-1, ::-1],
                        (2, 3, 0, 1)).copy()


def generator_state_dict_from_jax(params, batch_stats) -> dict:
    """JAX DCGAN generator ``(params, batch_stats)`` (numpy leaves) -> the
    reference-layout torch state dict that ``Generator`` loads strictly."""
    def t(x):
        return torch.from_numpy(np.asarray(x, np.float32).copy())

    sd = {}
    for i, seq in enumerate(SEQ_CONVT):
        sd[f"main.{seq}.weight"] = torch.from_numpy(convt_hwio_to_torch(
            params[f"ConvTranspose_{i}"]["kernel"]))
    for i, seq in enumerate(SEQ_BN):
        sd[f"main.{seq}.weight"] = t(params[f"TorchBatchNorm_{i}"]["scale"])
        sd[f"main.{seq}.bias"] = t(params[f"TorchBatchNorm_{i}"]["bias"])
        sd[f"main.{seq}.running_mean"] = t(
            batch_stats[f"TorchBatchNorm_{i}"]["mean"])
        sd[f"main.{seq}.running_var"] = t(
            batch_stats[f"TorchBatchNorm_{i}"]["var"])
        sd[f"main.{seq}.num_batches_tracked"] = torch.zeros(
            (), dtype=torch.long)
    return sd


def load_generator_pth(path: str) -> dict:
    """Read a reference-layout generator state dict ``.pth`` onto the CPU
    without unpickling arbitrary code."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    if not isinstance(sd, dict):
        raise ValueError(f"{path} holds a {type(sd).__name__}, not a "
                         "state dict")
    return sd
