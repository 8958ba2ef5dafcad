"""ResNet-50, torchvision v1.5 graph, in plain ``torch.nn``
(role of xgan/models/resnet.py).

Bottleneck blocks with expansion 4 and the stride on the 3x3 conv;
``stage_sizes`` (3, 4, 6, 3) is ResNet-50 and smaller tuples cut the
depth. Parameters and buffers carry torchvision's ``resnet50`` state-dict
keys (``conv1``, ``bn1``, ``layer{s}.{b}.conv{i}``/``bn{i}``,
``layer{s}.0.downsample.{0,1}``, ``fc``), so torchvision checkpoints and
the JAX package's ``.pth`` exports load strictly.

Dtype policy of the JAX package: parameters are f32; each convolution
runs in the compute dtype; BatchNorm computes in f32 and returns the
compute dtype; the mean-pool and ``fc`` run in f32.

``forward`` takes NHWC images like the JAX model and makes them one
channels_last NCHW view, which cuDNN's convolutions take as they are.
With ``cam=True`` it also returns Grad-CAM's two targets: the pre-BN
output of ``layer4[-1].conv3`` (the module the reference's analyzer
hooks), in the autograd graph, and the layer4 output that feeds the
mean-pool (the JAX package's ``cam_tap`` and ``return_features``). In
train mode BN uses batch statistics and updates its running statistics
in place (momentum 0.1, the unbiased variance); a (B,) validity ``mask``
restricts the statistics to the valid rows of a padded tail batch
(``xgan_torch.models.layers.batch_norm``).

``remat=True`` (``--remat``) recomputes activations in the backward
instead of keeping them: ``torch.utils.checkpoint`` (non-reentrant)
around each Bottleneck (``remat_scope="block"``), each stage
(``"stage"``: only the four stage inputs are kept), or each stage whose
recompute checkpoints each of its blocks (``"nested"``). The recompute
runs BN with ``update_stats=False``, so each running statistic advances
once a step, as without remat, and it sees the same ``mask``. The
parameters and buffers, hence the state-dict keys, are those without
remat, so checkpoints move between the two; ``cam=True`` never remats.

``folds=k`` lays k ResNet-50s side by side as one network, the form XLA
gives a vmap of the JAX model over stacked fold states (``--parallel-
folds``): the k folds' activations are one ``(B, k*C, H, W)`` tensor,
fold-major in the channels; each convolution is one convolution with
``groups=k`` (weight ``(k*Cout, Cin, kh, kw)``), each BN a BN over the
k*C channels, so that its statistics reduce within a fold; ``fc`` holds
the folds' ``(k*classes, C)``. Each parameter and buffer is thus the k
models' tensors concatenated on its first axis. ``forward`` takes
``(k, B, H, W, 3)`` images and returns ``(k, B, classes)`` logits; the
train-mode ``mask`` is ``(k, B)``, each fold's row weights.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from xgan_torch.models.layers import batch_norm

WIDTHS = (64, 128, 256, 512)
REMAT_SCOPES = ("block", "stage", "nested")


def _conv(cin, cout, k, stride=1, padding=0, device=None, folds=1):
    """``folds`` convolutions cin -> cout as one with ``groups=folds``."""
    return nn.Conv2d(folds * cin, folds * cout, k, stride, padding,
                     bias=False, groups=folds, device=device)


def conv(conv: nn.Conv2d, x: torch.Tensor) -> torch.Tensor:
    """conv in ``x.dtype`` (f32 weights cast to it)."""
    return F.conv2d(x, conv.weight.to(x.dtype), None, conv.stride,
                    conv.padding, 1, conv.groups)


def conv_bn(conv_: nn.Conv2d, bn: nn.BatchNorm2d, x: torch.Tensor, *,
            train: bool, mask=None, update_stats: bool = True
            ) -> torch.Tensor:
    """:func:`conv`, then BN in f32 with its result in ``x.dtype``."""
    return batch_norm(bn, conv(conv_, x), train=train, mask=mask,
                      update_stats=update_stats)


def remat(fn, x: torch.Tensor, update_stats: bool) -> torch.Tensor:
    """``checkpoint(fn)`` on ``x``, where ``fn(x, update_stats)``: the
    first run passes ``update_stats`` on, the recompute in the backward
    passes False, so BN's running statistics advance once."""
    runs = []

    def run(x):
        runs.append(None)
        return fn(x, update_stats and len(runs) == 1)
    # preserve_rng_state=False: the forward draws nothing
    return checkpoint(run, x, use_reentrant=False, preserve_rng_state=False)


class Bottleneck(nn.Module):
    def __init__(self, cin: int, width: int, stride: int, downsample: bool,
                 device=None, folds: int = 1):
        super().__init__()
        kw = {"device": device, "folds": folds}
        self.conv1 = _conv(cin, width, 1, **kw)
        self.bn1 = nn.BatchNorm2d(folds * width, device=device)
        self.conv2 = _conv(width, width, 3, stride, 1, **kw)
        self.bn2 = nn.BatchNorm2d(folds * width, device=device)
        self.conv3 = _conv(width, width * 4, 1, **kw)
        self.bn3 = nn.BatchNorm2d(folds * width * 4, device=device)
        self.downsample = None
        if downsample:
            self.downsample = nn.Sequential(
                _conv(cin, width * 4, 1, stride, **kw),
                nn.BatchNorm2d(folds * width * 4, device=device))

    def forward(self, x, *, train: bool, mask=None, tap: bool = False,
                update_stats: bool = True):
        """The block's output, and with ``tap`` also conv3's pre-BN
        output. ``update_stats=False``: train-mode BN that leaves the
        running statistics (a remat recompute)."""
        kw = {"train": train, "mask": mask, "update_stats": update_stats}
        out = torch.relu(conv_bn(self.conv1, self.bn1, x, **kw))
        out = torch.relu(conv_bn(self.conv2, self.bn2, out, **kw))
        pre_bn = conv(self.conv3, out)
        out = batch_norm(self.bn3, pre_bn, **kw)
        identity = x
        if self.downsample is not None:
            identity = conv_bn(self.downsample[0], self.downsample[1], x,
                               **kw)
        out = torch.relu(out + identity)
        return (out, pre_bn) if tap else out


class ResNet50(nn.Module):
    def __init__(self, num_classes: int = 2, *,
                 stage_sizes=(3, 4, 6, 3),
                 dtype: torch.dtype = torch.float32,
                 device: torch.device | str | None = None,
                 generator: torch.Generator | None = None,
                 remat: bool = False, remat_scope: str = "block",
                 folds: int = 1):
        """``dtype``: compute dtype of the convolutions. ``generator``
        draws the init (it must live on ``device``): kaiming-normal
        fan-out convolutions (each fold's), BN scale 1 and bias 0, and
        torch's U(+-1/sqrt(fan_in)) for ``fc``. ``remat``,
        ``remat_scope``, ``folds``: see the module docstring."""
        super().__init__()
        if remat_scope not in REMAT_SCOPES:
            raise ValueError(f"remat_scope must be one of {REMAT_SCOPES}, "
                             f"got {remat_scope!r}")
        self.dtype = dtype
        self.remat, self.remat_scope = remat, remat_scope
        self.stage_sizes = tuple(stage_sizes)
        self.num_classes, self.folds = num_classes, folds
        self.conv1 = _conv(3, 64, 7, 2, 3, device=device, folds=folds)
        self.bn1 = nn.BatchNorm2d(folds * 64, device=device)
        cin = 64
        for stage, (blocks, width) in enumerate(zip(self.stage_sizes,
                                                    WIDTHS)):
            layer = []
            for b in range(blocks):
                stride = 2 if (stage > 0 and b == 0) else 1
                layer.append(Bottleneck(cin, width, stride, b == 0,
                                        device=device, folds=folds))
                cin = width * 4
            setattr(self, f"layer{stage + 1}", nn.Sequential(*layer))
        self.fc = nn.Linear(cin, folds * num_classes, device=device)
        self.reset_parameters(generator)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator | None = None):
        for m in self.modules():
            if isinstance(m, nn.Conv2d):
                for w in m.weight.chunk(self.folds):
                    nn.init.kaiming_normal_(w, mode="fan_out",
                                            nonlinearity="relu",
                                            generator=generator)
            elif isinstance(m, nn.BatchNorm2d):
                nn.init.ones_(m.weight)
                nn.init.zeros_(m.bias)
                m.reset_running_stats()
        bound = self.fc.in_features ** -0.5
        nn.init.uniform_(self.fc.weight, -bound, bound, generator=generator)
        nn.init.uniform_(self.fc.bias, -bound, bound, generator=generator)

    def blocks(self):
        for stage in range(len(self.stage_sizes)):
            yield from getattr(self, f"layer{stage + 1}")

    def forward(self, x: torch.Tensor, *, train: bool,
                mask: torch.Tensor | None = None, cam: bool = False):
        """x (B, H, W, 3) NHWC -> f32 logits (B, num_classes). ``mask``:
        (B,) validity weights for train-mode BN statistics. ``cam``:
        return (logits, the pre-BN output of ``layer4[-1].conv3``, the
        layer4 output), both NCHW views in the compute dtype. With k
        folds: x (k, B, H, W, 3), ``mask`` (k, B), logits (k, B,
        num_classes)."""
        x = x.to(self.dtype)
        if self.folds > 1:  # fold-major channels: (B, H, W, k*3)
            k, b, h, w, c = x.shape
            x = x.permute(1, 2, 3, 0, 4).reshape(b, h, w, k * c)
        x = x.permute(0, 3, 1, 2)  # channels_last NCHW view
        x = torch.relu(conv_bn(self.conv1, self.bn1, x, train=train,
                               mask=mask))
        x = F.max_pool2d(x, 3, 2, 1)
        if self.remat and train and not cam:
            for stage in range(len(self.stage_sizes)):
                x = self._remat_stage(getattr(self, f"layer{stage + 1}"), x,
                                      train, mask)
            return self._head(x)
        blocks = list(self.blocks())
        for block in blocks[:-1]:
            x = block(x, train=train, mask=mask)
        x, conv3 = blocks[-1](x, train=train, mask=mask, tap=True)
        logits = self._head(x)
        return (logits, conv3, x) if cam else logits

    def _head(self, x: torch.Tensor) -> torch.Tensor:
        """The mean-pool and ``fc`` in f32 (each fold's with k folds)."""
        feats = x.float().mean(dim=(2, 3))
        if self.folds == 1:
            return F.linear(feats, self.fc.weight, self.fc.bias)
        b, k = feats.shape[0], self.folds
        w = self.fc.weight.view(k, self.num_classes, -1)
        return torch.baddbmm(self.fc.bias.view(k, 1, -1),
                             feats.view(b, k, -1).transpose(0, 1),
                             w.transpose(1, 2))

    def _remat_stage(self, layer: nn.Sequential, x: torch.Tensor,
                     train: bool, mask) -> torch.Tensor:
        """One stage under ``remat_scope``."""
        def block_fn(block):
            return lambda x, update: block(x, train=train, mask=mask,
                                           update_stats=update)

        def stage_fn(x, update, nested=self.remat_scope == "nested"):
            for block in layer:
                x = (remat(block_fn(block), x, update) if nested
                     else block_fn(block)(x, update))
            return x

        if self.remat_scope == "block":
            for block in layer:
                x = remat(block_fn(block), x, True)
            return x
        return remat(stage_fn, x, True)
