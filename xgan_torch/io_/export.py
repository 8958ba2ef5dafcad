"""Self-contained serving artifacts of the port (role of
xgan/io_/export.py).

The JAX package exports StableHLO, which the port cannot run without
JAX. The port's artifact is a ``torch.export`` program with a symbolic
batch dimension, behind the JAX package's self-description envelope: the
magic ``XGAN.EXPORT.1\\n``, a ``<I`` length and a JSON header (the same
keys), then the bytes of ``torch.export.save``. The extension is ``.pt2``.

The programs mirror the JAX package's signatures:

- classifier: uint8 ``(b, s, s, 3)`` -> ``(labels (b,), prob_positive
  (b,))`` with the ImageNet normalization fused in
  (:func:`make_classifier_infer`, shared by export, predict and serve);
- generator: ``z (b, latent)`` float32 [+ ``labels (b,)`` int32 for the
  CGAN] -> uint8 images through ``tanh_to_u8``.

The weights are the program's buffers. An int8 artifact
(:mod:`xgan_torch.io_.quant`) keeps int8 tensors and dequantizes them in
the program on every call; a DCGAN or WGAN-GP generator then also repacks
its ConvT weights and folds its BN on every call
(``Generator.packed``), as tensor ops.

The ConvT route is chosen while the program is traced, by device and
dtype: a program exported on the CPU holds the plain version, one
exported on the card the kernel (a ``torch.ops.xgan_torch`` call, whose
fake kernel lets it trace). So an artifact runs only on the kind of
device it was exported on: :func:`load_exported_with_meta` refuses any
other, with a structured error, and the user re-exports there. Launches
of a kernel inside an artifact do not pass through the Python wrappers,
so ``xgan_torch.kernels.LAUNCHES`` does not see them; ``torch.profiler``
does.
"""
from __future__ import annotations

import io
import json
import os
import struct

import torch
from torch import nn

from xgan_torch.data.pipeline import normalize_images, tanh_to_u8
from xgan_torch.io_.quant import _is_qleaf, quantize_params

MAGIC = b"XGAN.EXPORT.1\n"
EXT = ".pt2"


def make_classifier_infer(model, tensors: dict | None = None):
    """The one classifier program: uint8 ``(b, s, s, 3)`` -> ``(labels
    (b,), prob_positive (b,))``, ImageNet normalization fused in.
    ``tensors``: {state-dict name: tensor} used in place of ``model``'s
    own (an artifact's, dequantized)."""
    def infer(imgs_u8):
        x = normalize_images(imgs_u8)
        if tensors is None:
            logits = model(x, train=False)
        else:
            logits = torch.func.functional_call(model, tensors, (x,),
                                                {"train": False})
        probs = torch.softmax(logits.float(), dim=-1)
        return torch.argmax(logits, dim=-1), probs[:, 1]
    return infer


def _generate(model, tensors: dict, z, labels=None):
    """uint8 images of the generator ``model`` on ``tensors``. A DCGAN or
    WGAN-GP generator whose ConvT weights come as weights (an int8
    artifact) repacks them here."""
    from xgan_torch.models.dcgan import Generator as KernelGenerator
    kwargs = {}
    if isinstance(model, KernelGenerator) and "w0_mat" not in tensors:
        kwargs["packed"] = model.packed(tensors)
    args = (z,) if labels is None else (z, labels)
    return tanh_to_u8(torch.func.functional_call(model, tensors, args,
                                                 kwargs))


def program_tensors(model, kind: str, quantize: str) -> dict:
    """The tensors an artifact of ``model`` holds: every parameter and
    persistent buffer (int8 leaves for ``quantize="int8"``). A
    full-precision DCGAN or WGAN-GP generator holds its packed eval
    tensors and its first BN in place of the raw ConvT weights."""
    if quantize == "int8":
        tensors = quantize_params(model)
    else:
        tensors = {n: p.detach() for n, p in model.named_parameters()}
    persistent = model.state_dict().keys()
    tensors.update((n, b) for n, b in model.named_buffers()
                   if n in persistent)
    if kind in ("gan", "wgan") and quantize == "none":
        from xgan_torch.models.dcgan import PACKED, SEQ_BN
        bn0 = f"main.{SEQ_BN[0]}."
        tensors = {n: t for n, t in tensors.items() if n.startswith(bn0)}
        tensors.update((n, getattr(model, n)) for n in PACKED)
    return tensors


class Program(nn.Module):
    """``fn(tensors, *inputs)`` over the tensors it holds as buffers,
    each int8 leaf dequantized on every call. ``fn`` closes over the model
    without registering it, so the program holds no other weights."""

    def __init__(self, fn, tensors: dict):
        super().__init__()
        self.fn = fn
        self.keys = []
        for name, v in tensors.items():
            key = name.replace(".", "__")
            if _is_qleaf(v):
                self.register_buffer(f"{key}__q8", v["q8"])
                self.register_buffer(f"{key}__q8_scale", v["q8_scale"])
            else:
                self.register_buffer(key, v.detach())
            self.keys.append((name, key, _is_qleaf(v)))

    def tensors(self) -> dict:
        return {name: (getattr(self, f"{key}__q8").float()
                       * getattr(self, f"{key}__q8_scale") if q
                       else getattr(self, key))
                for name, key, q in self.keys}

    def forward(self, *inputs):
        return self.fn(self.tensors(), *inputs)


def build_program(kind: str, model, *, quantize: str = "none") -> Program:
    """The (not yet exported) program of ``kind`` (classifier, gan, wgan,
    cgan) on ``model``."""
    tensors = program_tensors(model, kind, quantize)
    if kind == "classifier":
        def fn(t, imgs):
            return make_classifier_infer(model, t)(imgs)
    elif kind == "cgan":
        def fn(t, z, labels):
            return _generate(model, t, z, labels)
    else:
        def fn(t, z):
            return _generate(model, t, z)
    return Program(fn, tensors)


def example_inputs(kind: str, *, image_size: int, latent_dim: int,
                   device) -> tuple:
    if kind == "classifier":
        return (torch.zeros((2, image_size, image_size, 3), dtype=torch.uint8,
                            device=device),)
    z = torch.zeros((2, latent_dim), device=device)
    if kind == "cgan":
        return z, torch.zeros((2,), dtype=torch.int32, device=device)
    return (z,)


MAX_BATCH = 65535  # cuDNN's f32 convolutions take no larger batch


def export_program(program: Program, inputs: tuple):
    """``torch.export`` of ``program`` with every input's dim 0 one
    symbolic batch dimension, 1 to :data:`MAX_BATCH`."""
    b = torch.export.Dim("b", min=1, max=MAX_BATCH)
    with torch.no_grad():  # one entry: forward's *inputs
        return torch.export.export(
            program, inputs, dynamic_shapes=(tuple({0: b} for _ in inputs),))


def save_exported(path: str, ep, meta: dict | None = None) -> int:
    """Write ``ep`` behind the envelope; returns the program's byte
    count (the envelope excluded)."""
    buf = io.BytesIO()
    torch.export.save(ep, buf)
    blob = buf.getvalue()
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "wb") as f:
        if meta is not None:
            header = json.dumps(meta, sort_keys=True).encode()
            f.write(MAGIC)
            f.write(struct.pack("<I", len(header)))
            f.write(header)
        f.write(blob)
    return len(blob)


def split_envelope(data: bytes):
    """``(meta or None, program bytes)``."""
    if data.startswith(MAGIC):
        (n,) = struct.unpack_from("<I", data, len(MAGIC))
        off = len(MAGIC) + 4
        return json.loads(data[off:off + n]), data[off + n:]
    return None, data


class Artifact:
    """A loaded program: ``call(*inputs)`` runs it without autograd;
    ``inputs`` lists each input's (shape with None for the batch, dtype);
    ``kernel_ops`` names the ``torch.ops.xgan_torch`` ops it calls."""

    def __init__(self, ep):
        self.program = ep
        self.module = ep.module()
        user = set(ep.graph_signature.user_inputs)
        self.inputs, self.device = [], None
        for node in ep.graph.nodes:
            if node.op == "placeholder" and node.name in user:
                val = node.meta["val"]
                self.inputs.append((tuple(d if isinstance(d, int) else None
                                          for d in val.shape), val.dtype))
                self.device = val.device
        self.kernel_ops = sorted({
            str(n.target) for n in ep.graph.nodes
            if n.op == "call_function" and "xgan_torch." in str(n.target)})

    def call(self, *inputs):
        with torch.no_grad():
            return self.module(*inputs)


def load_exported_with_meta(path: str, device: torch.device):
    """``(Artifact, meta or None)`` for the artifact at ``path``, to run
    on ``device``. Raises ValueError for an artifact exported on another
    kind of device: on the card, a program exported on the CPU would run
    the plain versions of the kernels."""
    device = torch.device(device)
    if device.type == "cuda":
        from xgan_torch.kernels.build import load_ops
        load_ops()  # the program's ops must exist before it is read
    with open(path, "rb") as f:
        meta, blob = split_envelope(f.read())
    art = Artifact(torch.export.load(io.BytesIO(blob)))
    if art.device is not None and art.device.type != device.type:
        where = ("on the card" if device.type == "cuda"
                 else "with --cpu")
        raise ValueError(
            f"{path} was exported on {art.device.type}, so its program "
            f"runs only there (exported on the CPU, it holds the plain "
            f"versions of the kernels); re-export it {where} with "
            "python -m xgan_torch.cli.export_model")
    return art, meta


def load_exported(path: str, device: torch.device) -> Artifact:
    return load_exported_with_meta(path, device)[0]


def dtype_name(dtype: torch.dtype) -> str:
    """The JAX package's ``compute_dtype`` name of ``dtype``."""
    return str(dtype).split(".")[-1]
