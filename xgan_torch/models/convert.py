"""Checkpoint interop (role of xgan/models/pretrained.py).

Generator: the JAX package keeps ConvT kernels as HWIO arrays that are
the spatial flip of torch's ``(I, O, kh, kw)`` ConvTranspose2d weights;
the DCGAN generator's state dict uses the reference ``nn.Sequential``
indices (``xgan_torch.models.dcgan.SEQ_CONVT`` / ``SEQ_BN``).

The WGAN-GP generator has the same layout (only the widths differ), so
``generator_state_dict_from_jax`` carries it across too.

Discriminator and WGAN-GP critic: flax ``Conv_i`` HWIO kernels become torch
OIHW weights and ``TorchBatchNorm_i`` the BNs, at the reference indices
``SEQ_D_CONV`` / ``SEQ_D_BN`` (critic: ``SEQ_C_CONV`` / ``SEQ_C_BN``).

CGAN: the same for the convs (with biases) and BNs, plus the two tensors
whose flatten order differs: the JAX package views G's ``fc`` output and
flattens D's last map HWC, the reference CHW, so ``fc``'s columns and D's
``label_emb`` columns are permuted. VGG16: the seven ``{name}_kernel`` /
``_bias`` params onto torchvision's ``features.{idx}``.

ResNet-50: the JAX package's parameter tree (``stem``,
``layer{s}_{b}/conv{i}``, ``downsample``, each with its ``bn``; ``fc``)
maps onto torchvision's keys with HWIO -> OIHW convolutions and the
``fc`` kernel (in, out) -> (out, in). Torchvision ``.pth`` files load
under the JAX importer's rules (``load_resnet_pth``).
"""
from __future__ import annotations

import numpy as np
import torch

from xgan_torch.models.cgan import SEQ_D_BN as SEQ_CGAN_D_BN
from xgan_torch.models.cgan import SEQ_D_CONV as SEQ_CGAN_D_CONV
from xgan_torch.models.cgan import SEQ_G_BN, SEQ_G_CONV
from xgan_torch.models.dcgan import SEQ_BN, SEQ_CONVT, SEQ_D_BN, SEQ_D_CONV
from xgan_torch.models.vgg import VGG_LAYERS
from xgan_torch.models.wgan import SEQ_C_BN, SEQ_C_CONV


def convt_hwio_to_torch(w) -> np.ndarray:
    """JAX-package HWIO ConvT kernel -> torch (I, O, kh, kw), flipping
    kh and kw. ``.copy()``: the flip leaves negative strides."""
    return np.transpose(np.asarray(w, np.float32)[::-1, ::-1],
                        (2, 3, 0, 1)).copy()


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.asarray(x, np.float32).copy())


def _put_bn(sd: dict, seq: int, params, stats) -> None:
    """A flax ``TorchBatchNorm``'s parameters and statistics as the
    reference BN at ``main.{seq}``."""
    sd[f"main.{seq}.weight"] = _t(params["scale"])
    sd[f"main.{seq}.bias"] = _t(params["bias"])
    sd[f"main.{seq}.running_mean"] = _t(stats["mean"])
    sd[f"main.{seq}.running_var"] = _t(stats["var"])
    sd[f"main.{seq}.num_batches_tracked"] = torch.zeros((), dtype=torch.long)


def generator_state_dict_from_jax(params, batch_stats) -> dict:
    """JAX DCGAN or WGAN-GP generator ``(params, batch_stats)`` (numpy
    leaves) -> the reference-layout torch state dict that ``Generator``
    loads strictly."""
    sd = {}
    for i, seq in enumerate(SEQ_CONVT):
        sd[f"main.{seq}.weight"] = torch.from_numpy(convt_hwio_to_torch(
            params[f"ConvTranspose_{i}"]["kernel"]))
    for i, seq in enumerate(SEQ_BN):
        _put_bn(sd, seq, params[f"TorchBatchNorm_{i}"],
                batch_stats[f"TorchBatchNorm_{i}"])
    return sd


BN_BUFFERS = ("running_mean", "running_var", "num_batches_tracked")


def ema_from_jax(ema_params, batch_stats,
                 convert=generator_state_dict_from_jax) -> dict:
    """A JAX generator EMA params tree (``--ema-decay``) -> the port's
    EMA as :func:`xgan_torch.train.ema.init_ema` makes it and a snapshot's
    ``ema`` holds it: {parameter name: f32 tensor}, without the BN
    buffers. ``batch_stats``: the raw generator's, which ``convert``, the
    family's generator converter (:func:`cgan_generator_state_dict_from_jax`
    for the CGAN), lays out beside the parameters and this drops."""
    return {k: v.float() for k, v in convert(ema_params, batch_stats).items()
            if k.rsplit(".", 1)[-1] not in BN_BUFFERS}


def _conv_stack_state_dict(params, batch_stats, seq_conv, seq_bn) -> dict:
    """Flax ``Conv_i`` (HWIO) and ``TorchBatchNorm_i`` -> torch OIHW convs
    at ``main.{seq_conv[i]}`` and BNs at ``main.{seq_bn[i]}``."""
    sd = {}
    for i, seq in enumerate(seq_conv):
        sd[f"main.{seq}.weight"] = _t(np.transpose(
            np.asarray(params[f"Conv_{i}"]["kernel"]), (3, 2, 0, 1)))
    for i, seq in enumerate(seq_bn):
        _put_bn(sd, seq, params[f"TorchBatchNorm_{i}"],
                batch_stats[f"TorchBatchNorm_{i}"])
    return sd


def discriminator_state_dict_from_jax(params, batch_stats) -> dict:
    """JAX DCGAN discriminator ``(params, batch_stats)`` (numpy leaves) ->
    the reference-layout torch state dict that ``Discriminator`` loads
    strictly."""
    return _conv_stack_state_dict(params, batch_stats, SEQ_D_CONV, SEQ_D_BN)


def critic_state_dict_from_jax(params, batch_stats) -> dict:
    """JAX WGAN-GP critic ``(params, batch_stats)`` (numpy leaves) -> the
    reference-layout torch state dict that ``xgan_torch.models.wgan.Critic``
    loads strictly."""
    return _conv_stack_state_dict(params, batch_stats, SEQ_C_CONV, SEQ_C_BN)


def chw_to_hwc_perm(c: int, s0: int) -> np.ndarray:
    """``perm[i_hwc] = i_chw`` for a flattened (c, s0, s0) <-> (s0, s0, c)
    reindexing (a copy of the JAX package's ``_chw_to_hwc_perm``): the
    reference views the CGAN ``fc`` output and flattens D's last map CHW,
    the JAX package HWC."""
    chw = np.arange(c * s0 * s0).reshape(c, s0, s0)
    return np.transpose(chw, (1, 2, 0)).reshape(-1)


def _conv_with_bias(p) -> tuple[torch.Tensor, torch.Tensor]:
    """A flax ``Conv`` with bias (HWIO kernel) as torch (OIHW, bias)."""
    return (_t(np.transpose(np.asarray(p["kernel"]), (3, 2, 0, 1))),
            _t(p["bias"]))


def cgan_generator_state_dict_from_jax(params, batch_stats) -> dict:
    """JAX CGAN generator ``(params, batch_stats)`` (numpy leaves) -> the
    reference-layout torch state dict that
    ``xgan_torch.models.cgan.Generator`` loads strictly: ``fc``'s columns
    and bias from HWC to CHW order, HWIO -> OIHW convs."""
    nf8 = np.asarray(params["TorchBatchNorm_0"]["scale"]).shape[0]
    kernel = np.asarray(params["Dense_0"]["kernel"], np.float32)
    s0 = int(round((kernel.shape[1] / nf8) ** 0.5))
    inv = np.argsort(chw_to_hwc_perm(nf8, s0))
    sd = {"label_emb.weight": _t(params["label_emb"]),
          "fc.weight": _t(np.transpose(kernel[:, inv])),
          "fc.bias": _t(np.asarray(params["Dense_0"]["bias"])[inv])}
    for i, seq in enumerate(SEQ_G_CONV):
        sd[f"main.{seq}.weight"], sd[f"main.{seq}.bias"] = _conv_with_bias(
            params[f"Conv_{i}"])
    for i, seq in enumerate(SEQ_G_BN):
        _put_bn(sd, seq, params[f"TorchBatchNorm_{i}"],
                batch_stats[f"TorchBatchNorm_{i}"])
    return sd


def cgan_discriminator_state_dict_from_jax(params, batch_stats) -> dict:
    """JAX CGAN projection discriminator ``(params, batch_stats)`` (numpy
    leaves) -> the reference-layout state dict that
    ``xgan_torch.models.cgan.Discriminator`` loads strictly: the
    embedding's columns from HWC to CHW order, HWIO -> OIHW convs."""
    emb = np.asarray(params["label_emb"], np.float32)
    nf8 = np.asarray(params["Conv_4"]["kernel"]).shape[-1]
    s0 = int(round((emb.shape[1] / nf8) ** 0.5))
    sd = {"label_emb.weight": _t(emb[:, np.argsort(chw_to_hwc_perm(nf8,
                                                                   s0))])}
    for i, seq in enumerate(SEQ_CGAN_D_CONV):
        sd[f"main.{seq}.weight"], sd[f"main.{seq}.bias"] = _conv_with_bias(
            params[f"Conv_{i}"])
    for i, seq in enumerate(SEQ_CGAN_D_BN):
        _put_bn(sd, seq, params[f"TorchBatchNorm_{i}"],
                batch_stats[f"TorchBatchNorm_{i}"])
    return sd


def vgg_state_dict_from_jax(params) -> dict:
    """JAX ``VGG16Features`` params (``{name}_kernel`` HWIO,
    ``{name}_bias``) -> the torchvision-layout ``features.{idx}`` state
    dict of ``xgan_torch.models.vgg.VGG16Features``."""
    sd = {}
    for name, idx in VGG_LAYERS:
        sd[f"features.{idx}.weight"], sd[f"features.{idx}.bias"] = \
            _conv_with_bias({"kernel": params[f"{name}_kernel"],
                             "bias": params[f"{name}_bias"]})
    return sd


def load_generator_pth(path: str) -> dict:
    """Read a reference-layout generator state dict ``.pth`` onto the CPU
    without unpickling arbitrary code."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    if not isinstance(sd, dict):
        raise ValueError(f"{path} holds a {type(sd).__name__}, not a "
                         "state dict")
    return sd


def resnet_state_dict_from_flax(params, batch_stats,
                                stage_sizes=(3, 4, 6, 3)) -> dict:
    """JAX ResNet50 ``(params, batch_stats)`` (numpy leaves) -> the
    torchvision-layout state dict that ``ResNet50`` loads strictly."""
    sd = {}

    def put(conv_key, bn_prefix, p, s):
        sd[conv_key] = _t(np.transpose(np.asarray(p["kernel"]),
                                       (3, 2, 0, 1)))
        sd[f"{bn_prefix}.weight"] = _t(p["bn"]["scale"])
        sd[f"{bn_prefix}.bias"] = _t(p["bn"]["bias"])
        sd[f"{bn_prefix}.running_mean"] = _t(s["bn"]["mean"])
        sd[f"{bn_prefix}.running_var"] = _t(s["bn"]["var"])
        sd[f"{bn_prefix}.num_batches_tracked"] = torch.zeros(
            (), dtype=torch.long)

    put("conv1.weight", "bn1", params["stem"], batch_stats["stem"])
    for stage, blocks in enumerate(stage_sizes, start=1):
        for b in range(blocks):
            src, dst = f"layer{stage}_{b}", f"layer{stage}.{b}"
            for i in (1, 2, 3):
                put(f"{dst}.conv{i}.weight", f"{dst}.bn{i}",
                    params[src][f"conv{i}"], batch_stats[src][f"conv{i}"])
            if "downsample" in params[src]:
                put(f"{dst}.downsample.0.weight", f"{dst}.downsample.1",
                    params[src]["downsample"],
                    batch_stats[src]["downsample"])
    sd["fc.weight"] = _t(np.transpose(np.asarray(params["fc"]["kernel"])))
    sd["fc.bias"] = _t(params["fc"]["bias"])
    return sd


def load_resnet_pth(model, path: str) -> None:
    """Load a torchvision ``resnet50`` state dict into ``model`` (a
    ``xgan_torch.models.resnet.ResNet50``), as the JAX importer does:

    - a deeper net (``layer{s}.{blocks}.conv1.weight`` present for the
      model's ``stage_sizes``) is rejected rather than loaded in part;
    - the file's ``fc`` is used only when it has the model's number of
      outputs (one of the port's own exports); an ImageNet 1000-way head
      leaves the model's fresh ``fc`` in place;
    - every other tensor of the model must be in the file.

    Raises ``ValueError`` on a mismatch."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    if hasattr(sd, "state_dict"):
        sd = sd.state_dict()
    if not isinstance(sd, dict):
        raise ValueError(f"{path} holds a {type(sd).__name__}, not a "
                         "state dict")
    for stage, blocks in enumerate(model.stage_sizes, start=1):
        extra = f"layer{stage}.{blocks}.conv1.weight"
        if extra in sd:
            raise ValueError(
                f"state dict has unexpected block {extra!r}: not a "
                f"torchvision resnet with stages {model.stage_sizes} "
                "(deeper variant, e.g. resnet101/152?)")
    own = model.state_dict()
    take = {}
    for k, v in own.items():
        if k.startswith("fc."):
            if k in sd and sd["fc.weight"].shape == own["fc.weight"].shape:
                take[k] = sd[k]
        elif k in sd:
            take[k] = sd[k]
        elif not k.endswith("num_batches_tracked"):
            raise ValueError(f"{path}: missing {k!r} for a resnet with "
                             f"stages {model.stage_sizes}")
    for k, v in take.items():
        if tuple(v.shape) != tuple(own[k].shape):
            raise ValueError(f"{path}: {k} has shape {tuple(v.shape)}, the "
                             f"model {tuple(own[k].shape)}")
    model.load_state_dict(take, strict=False)
