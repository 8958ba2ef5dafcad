"""flax's msgpack checkpoint format in the standard library alone (role of
``flax.serialization.{to_bytes,from_bytes}``, which
``xgan/io_/checkpoint.py`` writes and reads).

The GPU host has neither the ``msgpack`` package nor ``ml_dtypes``, so
this codec is written with ``struct``. It reads and writes what flax's
state dicts hold:

- maps with string keys, str, int, float (always 64-bit, as
  ``msgpack.packb`` writes it), bool, nil and bin;
- ext type 1, an ndarray packed as the msgpack array ``(shape, dtype
  name, C-order bytes)``, and ext type 3, a numpy scalar packed the same
  way;
- flax's chunked arrays (``__msgpack_chunked_array__``), which flax
  writes for a leaf above :data:`MAX_CHUNK_SIZE` bytes;
- lists and tuples, which flax stores as ``{"0": ..., "1": ...}`` maps
  (:func:`from_state_dict` turns them back into lists given a template).

``bfloat16`` leaves have no numpy dtype without ``ml_dtypes``; they are
read into ``torch.bfloat16`` tensors, and a ``torch.bfloat16`` tensor is
written as flax writes a bfloat16 array. Every other array leaf is a
numpy array. Keys keep their order both ways, so :func:`msgpack_serialize`
of a tree of numpy arrays gives the bytes of ``flax.serialization.to_bytes``
of the same tree.
"""
from __future__ import annotations

import struct
from typing import Any

import numpy as np
import torch

MAX_CHUNK_SIZE = 2 ** 30  # flax.serialization.MAX_CHUNK_SIZE
_EXT_NDARRAY, _EXT_NPSCALAR = 1, 3
_CHUNKED = "__msgpack_chunked_array__"


# ---- reading -------------------------------------------------------------

class _Reader:
    def __init__(self, data: bytes, ext_hook=None):
        self.data = memoryview(data)
        self.pos = 0
        self.ext_hook = ext_hook

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.data):
            raise ValueError("truncated msgpack data")
        out = self.data[self.pos:self.pos + n]
        self.pos += n
        return out

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def obj(self, raw: bool = False):
        b = self.unpack(">B")
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self._map(b & 0x0F, raw)
        if 0x90 <= b <= 0x9F:
            return [self.obj(raw) for _ in range(b & 0x0F)]
        if 0xA0 <= b <= 0xBF:
            return self._str(b & 0x1F, raw)
        simple = {0xC0: None, 0xC2: False, 0xC3: True}
        if b in simple:
            return simple[b]
        ints = {0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q",
                0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q",
                0xCA: ">f", 0xCB: ">d"}
        if b in ints:
            return self.unpack(ints[b])
        if b in (0xC4, 0xC5, 0xC6):
            return bytes(self.take(self.unpack((">B", ">H", ">I")[b - 0xC4])))
        if b in (0xD9, 0xDA, 0xDB):
            return self._str(self.unpack((">B", ">H", ">I")[b - 0xD9]), raw)
        if b in (0xDC, 0xDD):
            n = self.unpack(">H" if b == 0xDC else ">I")
            return [self.obj(raw) for _ in range(n)]
        if b in (0xDE, 0xDF):
            return self._map(self.unpack(">H" if b == 0xDE else ">I"), raw)
        if 0xD4 <= b <= 0xD8:
            return self._ext(1 << (b - 0xD4))
        if b in (0xC7, 0xC8, 0xC9):
            return self._ext(self.unpack((">B", ">H", ">I")[b - 0xC7]))
        raise ValueError(f"unsupported msgpack type byte 0x{b:02x}")

    def _str(self, n: int, raw: bool):
        s = bytes(self.take(n))
        return s if raw else s.decode("utf-8")

    def _map(self, n: int, raw: bool) -> dict:
        out = {}
        for _ in range(n):
            k = self.obj(raw)
            out[k] = self.obj(raw)
        return out

    def _ext(self, n: int):
        code = self.unpack(">b")
        payload = bytes(self.take(n))
        if code == _EXT_NDARRAY:
            return _ndarray_from_bytes(payload)
        if code == _EXT_NPSCALAR:
            arr = _ndarray_from_bytes(payload)
            return arr[()] if isinstance(arr, np.ndarray) else arr.reshape(())
        raise ValueError(f"unsupported msgpack ext type {code}")


def _ndarray_from_bytes(payload: bytes):
    r = _Reader(payload)
    shape, name, buf = r.obj(raw=True)
    shape = tuple(shape)
    if name == b"bfloat16":
        if not buf:
            return torch.empty(shape, dtype=torch.bfloat16)
        return torch.frombuffer(bytearray(buf),
                                dtype=torch.bfloat16).reshape(shape)
    return np.frombuffer(buf, dtype=np.dtype(name.decode())).reshape(shape)


def _unchunk(d: dict):
    shape = tuple(d["shape"][str(i)] for i in range(len(d["shape"])))
    chunks = [d["chunks"][str(i)] for i in range(len(d["chunks"]))]
    if isinstance(chunks[0], torch.Tensor):
        return torch.cat(chunks).reshape(shape)
    return np.concatenate(chunks).reshape(shape)


def _unchunk_leaves(d):
    if isinstance(d, dict):
        if _CHUNKED in d:
            return _unchunk(d)
        for k, v in d.items():
            d[k] = _unchunk_leaves(v)
    return d


def msgpack_restore(data: bytes) -> Any:
    """The state dict in ``data`` (``flax.serialization.msgpack_restore``):
    nested dicts with numpy (or, for bfloat16, torch) array leaves."""
    r = _Reader(data)
    out = r.obj()
    if r.pos != len(r.data):
        raise ValueError(f"{len(r.data) - r.pos} bytes after the msgpack "
                         "object")
    return _unchunk_leaves(out)


def _path(path: tuple) -> str:
    return "/" + "/".join(path)


def from_state_dict(target, state, path: tuple = ()):
    """Restore ``state`` into the structure of ``target`` as flax's
    ``from_state_dict`` does for dicts, lists and tuples: a key of
    ``target`` missing from ``state`` raises (keys only in ``state`` are
    dropped), a list's length must match, and leaves are taken from
    ``state`` whatever their shape (:func:`xgan_torch.io_.checkpoint.
    check_leaf_shapes` checks those)."""
    if isinstance(target, dict):
        if not isinstance(state, dict):
            raise ValueError(f"expected a map at path {_path(path)}, got "
                             f"{type(state).__name__}")
        diff = set(map(str, target)).difference(state)
        if diff:
            raise ValueError(
                "The target dict keys and state dict keys do not match, "
                f"target dict contains keys {diff} which are not present in "
                f"state dict at path {_path(path)}")
        return {k: from_state_dict(v, state[str(k)], path + (str(k),))
                for k, v in target.items()}
    if isinstance(target, (list, tuple)):
        if not isinstance(state, dict) or len(state) != len(target):
            n = len(state) if isinstance(state, dict) else "no"
            raise ValueError(
                "The size of the list and the state dict do not match, got "
                f"{len(target)} and {n} at path {_path(path)}")
        out = [from_state_dict(t, state[str(i)], path + (str(i),))
               for i, t in enumerate(target)]
        return type(target)(out) if isinstance(target, tuple) else out
    return state


def from_bytes(target, data: bytes):
    """``flax.serialization.from_bytes``: restore ``data`` into the
    structure of ``target``."""
    return from_state_dict(target, msgpack_restore(data))


# ---- writing -------------------------------------------------------------

def _pack_len(out: bytearray, n: int, fix_base: int | None, fix_max: int,
              codes: tuple) -> None:
    """A length header: the fix form below ``fix_max``, else the 8-, 16-
    or 32-bit form (``codes``; None where msgpack has no such form)."""
    if fix_base is not None and n < fix_max:
        out.append(fix_base | n)
    elif codes[0] is not None and n <= 0xFF:
        out += struct.pack(">BB", codes[0], n)
    elif n <= 0xFFFF:
        out += struct.pack(">BH", codes[1], n)
    elif n <= 0xFFFFFFFF:
        out += struct.pack(">BI", codes[2], n)
    else:
        raise ValueError(f"msgpack object too large ({n})")


def _pack_int(out: bytearray, v: int) -> None:
    if 0 <= v < 0x80 or -0x20 <= v < 0:
        out += struct.pack(">b" if v < 0 else ">B", v)
        return
    forms = ((0, 0xFF, 0xCC, ">B"), (0, 0xFFFF, 0xCD, ">H"),
             (0, 0xFFFFFFFF, 0xCE, ">I"), (0, 2 ** 64 - 1, 0xCF, ">Q"),
             (-0x80, -1, 0xD0, ">b"), (-0x8000, -1, 0xD1, ">h"),
             (-2 ** 31, -1, 0xD2, ">i"), (-2 ** 63, -1, 0xD3, ">q"))
    for lo, hi, code, fmt in forms:
        if lo <= v <= hi:
            out.append(code)
            out += struct.pack(fmt, v)
            return
    raise OverflowError(f"integer {v} does not fit msgpack")


def _pack_ext(out: bytearray, code: int, payload: bytes) -> None:
    n = len(payload)
    fix = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
    if n in fix:
        out.append(fix[n])
    else:
        _pack_len(out, n, None, 0, (0xC7, 0xC8, 0xC9))
    out += struct.pack(">b", code)
    out += payload


def _array_payload(arr) -> bytes:
    """(shape, dtype name, C-order bytes) as flax's ``_ndarray_to_bytes``
    packs them."""
    if isinstance(arr, torch.Tensor):
        t = arr.detach().cpu().contiguous()
        name = str(t.dtype).split(".")[-1]
        shape = tuple(t.shape)
        raw = t.view(torch.uint8).numpy().tobytes() if t.numel() else b""
    else:
        if arr.dtype.hasobject or arr.dtype.isalignedstruct:
            raise ValueError("Object and structured dtypes not supported "
                             "for serialization of ndarrays.")
        name, shape, raw = arr.dtype.name, arr.shape, arr.tobytes("C")
    out = bytearray()
    _pack_obj(out, [list(shape), name, raw])
    return bytes(out)


def _pack_obj(out: bytearray, v) -> None:
    if v is None:
        out.append(0xC0)
    elif v is True or v is False:
        out.append(0xC3 if v else 0xC2)
    elif type(v) is int:
        _pack_int(out, v)
    elif type(v) is float:
        out += struct.pack(">Bd", 0xCB, v)
    elif type(v) is str:
        s = v.encode("utf-8")
        _pack_len(out, len(s), 0xA0, 32, (0xD9, 0xDA, 0xDB))
        out += s
    elif type(v) in (bytes, bytearray):
        _pack_len(out, len(v), None, 0, (0xC4, 0xC5, 0xC6))
        out += v
    elif type(v) is dict:
        _pack_len(out, len(v), 0x80, 16, (None, 0xDE, 0xDF))
        for k, x in v.items():
            _pack_obj(out, k)
            _pack_obj(out, x)
    elif type(v) is list:
        _pack_len(out, len(v), 0x90, 16, (None, 0xDC, 0xDD))
        for x in v:
            _pack_obj(out, x)
    elif isinstance(v, (np.ndarray, torch.Tensor)):
        _pack_ext(out, _EXT_NDARRAY, _array_payload(v))
    elif isinstance(v, np.generic):
        _pack_ext(out, _EXT_NPSCALAR, _array_payload(np.asarray(v)))
    else:
        raise TypeError(f"can not serialize {type(v).__name__!r} object")


def _nbytes(a) -> int:
    return a.numel() * a.element_size() if isinstance(a, torch.Tensor) \
        else a.size * a.dtype.itemsize


def _chunk(arr) -> dict:
    itemsize = arr.element_size() if isinstance(arr, torch.Tensor) \
        else arr.dtype.itemsize
    size = max(1, int(MAX_CHUNK_SIZE / itemsize))
    flat = arr.reshape(-1)
    n = flat.shape[0]
    return {_CHUNKED: True,
            "shape": {str(i): int(s) for i, s in enumerate(arr.shape)},
            "chunks": {str(j): flat[i:i + size]
                       for j, i in enumerate(range(0, n, size))}}


def to_state_dict(tree):
    """flax's ``to_state_dict`` for dicts, lists and tuples (lists and
    tuples become ``{"0": ...}`` maps, keys become strings), with array
    leaves above :data:`MAX_CHUNK_SIZE` bytes chunked as flax chunks
    them."""
    if isinstance(tree, dict):
        keys = [str(k) for k in tree]
        if len(set(keys)) != len(keys):
            raise ValueError(f"Dict keys do not have a unique string "
                             f"representation: {keys}")
        return {str(k): to_state_dict(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return {str(i): to_state_dict(v) for i, v in enumerate(tree)}
    if isinstance(tree, (np.ndarray, torch.Tensor)) \
            and _nbytes(tree) > MAX_CHUNK_SIZE:
        return _chunk(tree)
    return tree


def msgpack_serialize(tree) -> bytes:
    """``flax.serialization.to_bytes`` of ``tree``: dicts, lists, tuples,
    Python scalars, numpy arrays and scalars, and torch tensors (written
    as the numpy array of their dtype; bfloat16 as flax writes it)."""
    out = bytearray()
    _pack_obj(out, to_state_dict(tree))
    return bytes(out)
