"""Reading the JAX package's checkpoints into the port's models (role of
xgan/io_/checkpoint.py).

``xgan`` writes flax ``.msgpack`` files of ``{"params", "batch_stats"}``
trees; :mod:`xgan_torch.io_.msgpack` reads them without flax. A tree is
restored into a template of the model's flax layout (:func:`flax_like`,
built from the port model's own shapes), every leaf's shape is checked
against it with the JAX package's error for the first leaf that differs,
and the existing converters of :mod:`xgan_torch.models.convert` carry it
onto the port model's state dict. Classifier ``.pth``/``.pt`` files are
torchvision ``resnet50`` state dicts, read as the JAX package's importer
reads them, with its errors.

The port's trainers write ``.pth`` (a recorded deviation): the JAX
package reads those already.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from xgan_torch.io_.msgpack import from_bytes
from xgan_torch.models import convert


def load_variables(path: str, like: Dict[str, Any]) -> Dict[str, Any]:
    """The tree in the ``.msgpack`` at ``path``, restored into the
    structure of ``like`` (leaf shapes unchecked)."""
    with open(path, "rb") as f:
        data = f.read()
    return from_bytes(like, data)


def _flatten_with_path(tree, path: str = ""):
    """(keystr path, leaf) pairs in ``jax.tree_util`` order: dict keys
    sorted, list items in order, None dropped."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flatten_with_path(tree[k], f"{path}[{k!r}]")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _flatten_with_path(v, f"{path}[{i}]")
    elif tree is not None:
        yield path, tree


def _shape(x) -> tuple:
    return tuple(x.shape) if hasattr(x, "shape") else np.shape(x)


def check_leaf_shapes(like: Dict[str, Any], loaded: Dict[str, Any],
                      context: str) -> None:
    """Raise ValueError naming the first leaf (in the JAX package's
    order) whose shape differs between ``like`` and ``loaded``."""
    for (pa, a), (_, b) in zip(_flatten_with_path(like),
                               _flatten_with_path(loaded)):
        if _shape(a) != _shape(b):
            raise ValueError(f"{context}: {pa} has checkpoint shape "
                             f"{_shape(b)}, expected {_shape(a)}")


def load_variables_checked(path: str, like: Dict[str, Any],
                           context: str | None = None) -> Dict[str, Any]:
    """:func:`load_variables` and the per-leaf shape check."""
    loaded = load_variables(path, like)
    check_leaf_shapes(like, loaded, context or
                      f"checkpoint {path} does not match the current "
                      "model flags")
    return loaded


# ---- the flax layout of the port's models --------------------------------

def _leaf(*shape) -> np.ndarray:
    """A shape-only template leaf (no memory behind it)."""
    return np.broadcast_to(np.float32(0), tuple(int(s) for s in shape))


def _bn_like(bn) -> tuple[dict, dict]:
    c = bn.weight.shape[0]
    return ({"scale": _leaf(c), "bias": _leaf(c)},
            {"mean": _leaf(c), "var": _leaf(c)})


def _conv_like(conv) -> np.ndarray:
    """An OIHW conv weight's flax HWIO kernel."""
    o, i, kh, kw = conv.weight.shape
    return _leaf(kh, kw, i, o)


def flax_like(model) -> Dict[str, Any]:
    """``{"params", "batch_stats"}`` template, in the JAX package's
    layout, of the port's DCGAN or WGAN-GP generator, CGAN generator or
    ResNet-50 classifier."""
    from xgan_torch.models import cgan, dcgan
    from xgan_torch.models.resnet import ResNet50
    params, stats = {}, {}
    if isinstance(model, dcgan.Generator):  # the WGAN-GP one too
        for i, seq in enumerate(dcgan.SEQ_CONVT):
            cin, cout, kh, kw = model.main[seq].weight.shape
            params[f"ConvTranspose_{i}"] = {"kernel": _leaf(kh, kw, cin,
                                                            cout)}
        for i, seq in enumerate(dcgan.SEQ_BN):
            name = f"TorchBatchNorm_{i}"
            params[name], stats[name] = _bn_like(model.main[seq])
    elif isinstance(model, cgan.Generator):
        params["label_emb"] = _leaf(*model.label_emb.weight.shape)
        out, latent = model.fc.weight.shape
        params["Dense_0"] = {"kernel": _leaf(latent, out),
                             "bias": _leaf(out)}
        for i, seq in enumerate(cgan.SEQ_G_CONV):
            conv = model.main[seq]
            params[f"Conv_{i}"] = {"kernel": _conv_like(conv),
                                   "bias": _leaf(conv.bias.shape[0])}
        for i, seq in enumerate(cgan.SEQ_G_BN):
            name = f"TorchBatchNorm_{i}"
            params[name], stats[name] = _bn_like(model.main[seq])
    elif isinstance(model, ResNet50):
        def unit(conv, bn):
            bp, bs = _bn_like(bn)
            return {"kernel": _conv_like(conv), "bn": bp}, {"bn": bs}

        params["stem"], stats["stem"] = unit(model.conv1, model.bn1)
        for stage, blocks in enumerate(model.stage_sizes, start=1):
            for b, block in enumerate(getattr(model, f"layer{stage}")):
                p, s = {}, {}
                for i in (1, 2, 3):
                    p[f"conv{i}"], s[f"conv{i}"] = unit(
                        getattr(block, f"conv{i}"), getattr(block, f"bn{i}"))
                if block.downsample is not None:
                    p["downsample"], s["downsample"] = unit(
                        block.downsample[0], block.downsample[1])
                params[f"layer{stage}_{b}"] = p
                stats[f"layer{stage}_{b}"] = s
        out, feats = model.fc.weight.shape
        params["fc"] = {"kernel": _leaf(feats, out), "bias": _leaf(out)}
    else:
        raise TypeError(f"no flax layout for {type(model).__name__}")
    return {"params": params, "batch_stats": stats}


def state_dict_from_flax(model, variables: Dict[str, Any]) -> dict:
    """The converter of :mod:`xgan_torch.models.convert` for ``model``'s
    family applied to restored flax ``variables`` (numpy leaves)."""
    from xgan_torch.models import cgan, dcgan
    p = _numpy_tree(variables["params"])
    s = _numpy_tree(variables["batch_stats"])
    if isinstance(model, dcgan.Generator):
        return convert.generator_state_dict_from_jax(p, s)
    if isinstance(model, cgan.Generator):
        return convert.cgan_generator_state_dict_from_jax(p, s)
    return convert.resnet_state_dict_from_flax(p, s, model.stage_sizes)


def _numpy_tree(tree):
    """bfloat16 leaves (torch tensors) as f32 numpy arrays, as the
    converters' ``np.asarray(..., np.float32)`` would read flax's."""
    if isinstance(tree, dict):
        return {k: _numpy_tree(v) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return tree.float().numpy()
    return tree


def load_flax_checkpoint(model, path: str, context: str):
    """Load the ``.msgpack`` at ``path`` into ``model`` (strictly) through
    its flax template; raises ValueError (a shape or layout mismatch,
    named as the JAX package names it) or OSError."""
    like = flax_like(model)
    variables = load_variables_checked(path, like, context)
    model.load_state_dict(state_dict_from_flax(model, variables),
                          strict=True)
    return model


# ---- classifiers ---------------------------------------------------------

def _resnet_tree_from_torch(sd: dict, num_classes: int, stage_sizes):
    """A torchvision ``resnet50`` state dict as flax ``(params,
    batch_stats)``, with the JAX importer's rules
    (``xgan.models.pretrained.load_torch_resnet50``): a deeper net is
    refused, a missing tensor raises KeyError, and ``fc`` is taken only
    when it has ``num_classes`` outputs."""
    for stage, blocks in enumerate(stage_sizes, start=1):
        extra = f"layer{stage}.{blocks}.conv1.weight"
        if extra in sd:
            raise ValueError(
                f"state dict has unexpected block {extra!r}: not a "
                f"torchvision resnet with stages {tuple(stage_sizes)} "
                "(deeper variant, e.g. resnet101/152?)")

    def np_(k):
        return sd[k].detach().float().numpy()

    def conv(k):
        return np.transpose(np_(k), (2, 3, 1, 0))

    def bn(prefix):
        return ({"scale": np_(f"{prefix}.weight"),
                 "bias": np_(f"{prefix}.bias")},
                {"mean": np_(f"{prefix}.running_mean"),
                 "var": np_(f"{prefix}.running_var")})

    params, stats = {}, {}
    bp, bs = bn("bn1")
    params["stem"] = {"kernel": conv("conv1.weight"), "bn": bp}
    stats["stem"] = {"bn": bs}
    for stage, blocks in enumerate(stage_sizes, start=1):
        for b in range(blocks):
            src, dst = f"layer{stage}.{b}", f"layer{stage}_{b}"
            p, s = {}, {}
            for i in (1, 2, 3):
                bp, bs = bn(f"{src}.bn{i}")
                p[f"conv{i}"] = {"kernel": conv(f"{src}.conv{i}.weight"),
                                 "bn": bp}
                s[f"conv{i}"] = {"bn": bs}
            if f"{src}.downsample.0.weight" in sd:
                bp, bs = bn(f"{src}.downsample.1")
                p["downsample"] = {
                    "kernel": conv(f"{src}.downsample.0.weight"), "bn": bp}
                s["downsample"] = {"bn": bs}
            params[dst], stats[dst] = p, s
    if "fc.weight" in sd and sd["fc.weight"].shape[0] == num_classes:
        params["fc"] = {"kernel": np_("fc.weight").T, "bias": np_("fc.bias")}
    return params, stats


def _structure(tree):
    if isinstance(tree, dict):
        return {k: _structure(v) for k, v in sorted(tree.items())}
    return None


def load_classifier_variables(path: str, model):
    """Load a classifier checkpoint into the port's ``ResNet50`` ``model``
    (counterpart of the JAX function of the same name): a ``.msgpack``
    the JAX package wrote, or a torchvision ``resnet50`` ``.pth``/``.pt``.
    Both formats get the per-leaf shape check; raises ValueError with the
    JAX package's messages (a missing tensor, no ``fc`` head, a layout
    mismatch, the first leaf whose shape differs)."""
    context = f"checkpoint {path} does not match the current model flags"
    if not path.endswith((".pth", ".pt")):
        return load_flax_checkpoint(model, path, context)
    like = flax_like(model)
    num_classes = model.num_classes
    stage_sizes = tuple(model.stage_sizes)
    sd = torch.load(path, map_location="cpu", weights_only=True)
    if hasattr(sd, "state_dict"):
        sd = sd.state_dict()
    if not isinstance(sd, dict):
        raise ValueError(f"{path} holds a {type(sd).__name__}, not a "
                         "state dict")
    try:
        params, stats = _resnet_tree_from_torch(sd, num_classes, stage_sizes)
    except KeyError as e:
        raise ValueError(
            f"{path}: state dict is missing {e} — not a torchvision "
            f"resnet50 of stages {stage_sizes}") from e
    if "fc" not in params:
        raise ValueError(
            f"{path}: state dict has no {num_classes}-way fc head — "
            "this looks like a raw ImageNet backbone, not a trained "
            "classifier (backbones go to --pretrained-path)")
    loaded = {"params": params, "batch_stats": stats}
    if _structure(like) != _structure(loaded):
        raise ValueError(
            f"{path}: state-dict layout does not match a torchvision "
            f"resnet50 of stages {stage_sizes}")
    check_leaf_shapes(like, loaded, context)
    model.load_state_dict(state_dict_from_flax(model, loaded), strict=True)
    return model

