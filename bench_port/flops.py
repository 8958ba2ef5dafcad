"""Model FLOPs and the ConvT layers' bytes, from the configuration's shapes.

A forward's FLOPs count 2 per multiply-add of every convolution, transposed
convolution and matrix product at full kernel size (padding not taken
out), as ``torch.utils.flop_counter`` counts them; normalization,
activations and losses are left out.

A step's model FLOPs count no recomputation: ``a``·F_G + ``c``·F_D, F_G
and F_D one forward of the generator and of the discriminator (or
critic), with the coefficients of the configuration's ``step_flops``:

- DCGAN (``dcgan_step``): a = 3 (G's forward, its backward ~2), c = 8 (D
  on the real and on the detached fake, forward and backward ~3 each; D on
  the fake for G's loss, forward and input gradient ~2);
- WGAN-GP (``wgan_step``, n critic updates): a = n + 3 (n + 1 forwards,
  one backward ~2), c = 12 n + 2 (per critic update 3 forwards, the
  penalty's input gradient ~1, the backward of the real and fake passes ~2
  each, of the penalty's forward and input-gradient graph ~2 + ~2; then
  G's pass through the critic, forward and input gradient).

The widths are those the configuration's plain reference builds
(its ``g_widths`` and ``d_widths``).

The ConvT bound of one generator forward is, per k4s2 layer,
``max(FLOPs / peak FLOP/s, bytes / peak bytes/s)``, the bytes being the
layer's input and output activations and its weight, each once, in the
compute dtype.
"""
from __future__ import annotations

from . import catalog

DTYPE_BYTES = {"bfloat16": 2, "float16": 2, "float32": 4}


def g_widths(cfg: dict) -> list[int]:
    return catalog.reference(cfg).g_widths(cfg)


def d_widths(cfg: dict) -> list[int]:
    return catalog.reference(cfg).d_widths(cfg)


def convt_layers(cfg: dict) -> list[tuple[int, int, int]]:
    """(H, Cin, Cout) of the generator's five k4s2 layers (input H = W)."""
    widths = g_widths(cfg) + [cfg["num_channels"]]
    h = cfg["image_size"] // 32
    out = []
    for i in range(5):
        out.append((h, widths[i], widths[i + 1]))
        h *= 2
    return out


def convt_flops(b: int, h: int, cin: int, cout: int) -> int:
    """One k4s2 layer: each of the (2H)² outputs sums 4 taps of Cin."""
    return 2 * b * (2 * h) ** 2 * cout * 4 * cin


def g_forward(cfg: dict, b: int) -> int:
    s0 = cfg["image_size"] // 32
    first = 2 * b * cfg["latent_dim"] * s0 * s0 * g_widths(cfg)[0]
    return first + sum(convt_flops(b, h, ci, co)
                       for h, ci, co in convt_layers(cfg))


def d_forward(cfg: dict, b: int) -> int:
    """The discriminator's (or critic's) convolutions: k4 s2 down to S/2^n,
    then the valid head of kernel S/32 to one channel."""
    s, s0 = cfg["image_size"], cfg["image_size"] // 32
    widths = [cfg["num_channels"]] + d_widths(cfg)
    total = 0
    for i in range(1, len(widths)):
        out = s // 2 ** i
        total += 2 * b * out * out * widths[i] * 16 * widths[i - 1]
    last = s // 2 ** (len(widths) - 1)
    head = last - s0 + 1
    return total + 2 * b * head * head * s0 * s0 * widths[-1]


def step(cfg: dict, b: int) -> int:
    """Model FLOPs of one train step at batch ``b``."""
    a, c = cfg["step_flops"]["g_forwards"], cfg["step_flops"]["d_forwards"]
    return a * g_forward(cfg, b) + c * d_forward(cfg, b)


def g_forwards_per_step(cfg: dict) -> int:
    """Generator train forwards in one step (each runs the five k4s2
    layers once)."""
    return cfg["g_train_forwards_per_step"]


def convt_bound_s(cfg: dict, b: int, peaks: dict) -> float:
    """The least time of one generator forward's five k4s2 layers."""
    nbytes = DTYPE_BYTES[cfg["compute_dtype"]]
    total = 0.0
    for h, cin, cout in convt_layers(cfg):
        moved = nbytes * (b * h * h * cin + 16 * cin * cout
                          + b * (2 * h) ** 2 * cout)
        total += max(convt_flops(b, h, cin, cout) / peaks["flops"],
                     moved / peaks["bytes_per_s"])
    return total
