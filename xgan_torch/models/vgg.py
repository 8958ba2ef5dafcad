"""VGG-16 feature prefix for the CGAN perceptual loss
(role of xgan/models/vgg.py).

The three frozen blocks of torchvision's ``vgg16().features`` that the
reference PerceptualLoss reads: ``[:4]`` -> relu1_2, ``[4:9]`` -> relu2_2,
``[9:16]`` -> relu3_3. The parameters sit in a ``features``
``nn.Sequential`` of torchvision's layout (convs at ``features.{0, 2, 5,
7, 10, 12, 14}``), so a torchvision ``vgg16`` state dict loads directly
(:func:`load_vgg16_pth`). They never require a gradient: the loss is
differentiated with respect to its input only.

Each conv runs in the compute ``dtype`` with f32 accumulation, its result
rounded to ``dtype``, the bias added in ``dtype``, then ReLU: the JAX
package's order (``xgan/models/vgg.py:32-43``). The convolutions are
cuDNN's, on channels_last NCHW views; the features come back NCHW.
Without a checkpoint the features are random (he_normal, as flax's
default for this module) and the trainer prints a warning.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from xgan_torch.ops.reduce import layerwise_mse

# torchvision vgg16.features indices of the convs the three blocks use
VGG_LAYERS = (("conv1_1", 0), ("conv1_2", 2), ("conv2_1", 5),
              ("conv2_2", 7), ("conv3_1", 10), ("conv3_2", 12),
              ("conv3_3", 14))
VGG_OUT_CHANNELS = (64, 64, 128, 128, 256, 256, 256)
# after relu1_2, relu2_2 and relu3_3
FEATURE_TAPS = (3, 8, 15)


class VGG16Features(nn.Module):
    def __init__(self, *, dtype: torch.dtype = torch.float32,
                 device: torch.device | str | None = None,
                 generator: torch.Generator | None = None):
        """``dtype``: compute dtype of the activations (parameters stay
        f32). ``generator`` draws the random init on ``device``: flax's
        ``he_normal``, a normal truncated at ±2 std with std
        sqrt(2 / (9 Cin)) / 0.8796, and zero biases."""
        super().__init__()
        self.dtype = dtype
        layers, cin = [], 3
        for v in (64, 64, "M", 128, 128, "M", 256, 256, 256):
            if v == "M":
                layers.append(nn.MaxPool2d(2, 2))
                continue
            layers += [nn.Conv2d(cin, v, 3, 1, 1, device=device),
                       nn.ReLU(inplace=True)]
            cin = v
        self.features = nn.Sequential(*layers)
        with torch.no_grad():
            for _, idx in VGG_LAYERS:
                conv = self.features[idx]
                # 0.8796...: the std of a unit normal truncated at ±2
                std = math.sqrt(2.0 / (9 * conv.in_channels)) \
                    / 0.87962566103423978
                nn.init.trunc_normal_(conv.weight, 0.0, std, -2 * std,
                                      2 * std, generator=generator)
                nn.init.zeros_(conv.bias)
        self.requires_grad_(False)

    def forward(self, x: torch.Tensor):
        """NHWC images (B, S, S, 3), any float dtype (cast to ``dtype``) ->
        (relu1_2, relu2_2, relu3_3), NCHW in ``dtype``."""
        x = x.to(self.dtype).permute(0, 3, 1, 2)
        feats = []
        for i, m in enumerate(self.features):
            if isinstance(m, nn.Conv2d):
                x = F.conv2d(x, m.weight.to(self.dtype), None, 1, 1)
                x = torch.relu(x + m.bias.to(self.dtype).view(1, -1, 1, 1))
            elif isinstance(m, nn.MaxPool2d):
                x = F.max_pool2d(x, 2, 2)
            if i in FEATURE_TAPS:
                feats.append(x)
        return tuple(feats)


def perceptual_loss(vgg: VGG16Features, x: torch.Tensor, y: torch.Tensor,
                    weights=None, mesh=None) -> torch.Tensor:
    """Sum of per-block MSEs between the features of ``x`` and ``y``
    (reference train_cgan.py:66-73). ``y``'s side runs under ``no_grad``
    (the JAX package stops its gradient). ``weights``: (B,) validity
    weights; each block's mean then covers the valid rows only.
    ``mesh``: this rank's share of the global loss (``layerwise_mse``;
    the VGG features are frozen and the same on every rank)."""
    fx = vgg(x)
    with torch.no_grad():
        fy = vgg(y)
    return layerwise_mse(fx, fy, weights, mesh)


def validate_vgg16_state_dict(sd: dict) -> None:
    """Raise ``ValueError`` unless ``sd`` holds torchvision vgg16's first
    three blocks: missing keys (vgg11/13, vgg16_bn), an extra conv at
    ``features.16`` (vgg19, whose first blocks would otherwise load as a
    silent mix) and wrong shapes. The JAX package's rules and messages."""
    missing = [f"features.{idx}.weight" for _, idx in VGG_LAYERS
               if f"features.{idx}.weight" not in sd]
    if missing:
        raise ValueError(
            f"missing {missing[:3]}...: not a torchvision vgg16 "
            "features state dict (vgg16_bn / other depths have "
            "different layer indices)")
    if "features.16.weight" in sd:
        raise ValueError(
            "state dict has an extra conv at features.16: a deeper VGG "
            "(vgg19?) — its first blocks would load as a silent "
            "frankenmodel, refusing instead")
    for (name, idx), out_ch in zip(VGG_LAYERS, VGG_OUT_CHANNELS):
        got = tuple(sd[f"features.{idx}.weight"].shape)
        if got[0] != out_ch or got[-2:] != (3, 3):
            raise ValueError(
                f"features.{idx}.weight has shape {got}, expected "
                f"({out_ch}, C, 3, 3) for vgg16 {name}")


def read_vgg16_pth(path: str) -> dict:
    """A torchvision vgg16 ``.pth`` (state dict or pickled module's state)
    read onto the CPU without unpickling code, then validated."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    if hasattr(sd, "state_dict"):
        sd = sd.state_dict()
    if not isinstance(sd, dict):
        raise ValueError(f"{path} holds a {type(sd).__name__}, not a "
                         "state dict")
    validate_vgg16_state_dict(sd)
    return sd


def load_vgg16_pth(model: VGG16Features, path: str) -> None:
    """Load the first three blocks of a torchvision vgg16 state dict into
    ``model``; the classifier and deeper blocks are ignored."""
    sd = read_vgg16_pth(path)
    keys = [f"features.{idx}.{p}" for _, idx in VGG_LAYERS
            for p in ("weight", "bias")]
    missing = [k for k in keys if k not in sd]
    if missing:
        raise ValueError(f"{path}: missing {missing[:3]}")
    model.load_state_dict({k: sd[k] for k in keys}, strict=True)
