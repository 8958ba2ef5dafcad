"""Builds the port's CUDA kernels from ``csrc/`` at first use.

The kernels (``*.cu``) hold no torch headers and are compiled for Hopper
(``sm_90a``, set explicitly: ``TORCH_CUDA_ARCH_LIST`` is not read). The op
bindings (``*.cpp``) hold only host code and are compiled against torch's
headers; one of them is a CPU op of its own, the PNG row unfilter of the
image store (``png_unfilter.cpp``). All compiles start together, then one
link makes a shared library that registers the ops under
``torch.ops.xgan_torch`` when :func:`load_ops` loads it.

``nvcc`` drives every step, so the host side goes through nvcc's own host
compiler and not through ``$CXX``: a ``$CXX`` wrapper whose op library
exported its own copies of C++ standard-library symbols crashed the
process as soon as a ``TORCH_CHECK`` formatted a number into its message.
The CUDA runtime is linked shared, so the process keeps the one that torch
loaded.

The library lands in ``xgan_torch/kernels/_build/`` under a name hashed
from the sources, flags and torch version, so a changed source rebuilds
and an unchanged one is reused. Beside it, a ``.log`` keeps what the
compiles printed (``ptxas -v``: registers, shared memory and spills of
each kernel), read back by :func:`build_log`. Nothing here runs at
import time: importing the package needs no ``nvcc``.
"""
from __future__ import annotations

import hashlib
import os
import subprocess
import threading
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
CUDA_SOURCES = ("convt4x4s2.cu", "convt4x4s2_mma.cu", "convt4x4s2_wgmma.cu",
                "convt4x4s2_band.cu", "mixed_gather.cu")
HEADERS = ("tensor_core.cuh",)  # included by the sources: part of the hash
HOST_SOURCES = ("convt_op.cpp", "gather_op.cpp", "png_unfilter.cpp")
CUDA_FLAGS = ("-O3", "-std=c++17", "-gencode=arch=compute_90a,code=sm_90a",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")
_ABI = int(torch._C._GLIBCXX_USE_CXX11_ABI)
# no device code in these steps: silence nvcc's default-arch notice
HOST_FLAGS = ("-O2", "-std=c++20", "-Xcompiler", "-fPIC",
              f"-D_GLIBCXX_USE_CXX11_ABI={_ABI}",
              "-Wno-deprecated-gpu-targets")
LINK_FLAGS = ("-shared", "-cudart", "shared", "-Wno-deprecated-gpu-targets")
LIBS = ("-lc10", "-lc10_cuda", "-ltorch_cpu", "-ltorch")

_load_lock = threading.Lock()
_loaded: list[Path] = []
_failed: list[Exception] = []  # a failed build is not retried per call


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME is None:
        raise RuntimeError("CUDA toolkit not found (no CUDA_HOME and no nvcc "
                           "on PATH); it is needed to build the xgan_torch "
                           "kernels")
    return os.path.join(CUDA_HOME, "bin", "nvcc")


def library_path() -> Path:
    """Where the library for the current sources and flags lives."""
    h = hashlib.sha256()
    for name in CUDA_SOURCES + HOST_SOURCES + HEADERS:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    for part in CUDA_FLAGS + HOST_FLAGS + LINK_FLAGS + LIBS + (
            torch.__version__,):
        h.update(part.encode())
    return BUILD_DIR / f"libxgan_torch_kernels_{h.hexdigest()[:16]}.so"


def _run_all(cmds: list[list[str]]) -> list[str]:
    """Start every command at once; raise with its output if one fails."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    outs, failed = [], []
    for cmd, proc in zip(cmds, procs):
        out, _ = proc.communicate()
        outs.append(out)
        if proc.returncode != 0:
            failed.append(f"$ {' '.join(cmd)}\n{out}")
    if failed:
        raise RuntimeError("xgan_torch kernel build failed:\n"
                           + "\n".join(failed))
    return outs


def build(verbose: bool = False) -> Path:
    """Compile and link the kernels unless the library is already built;
    returns its path."""
    so = library_path()
    if so.exists():
        return so
    from torch.utils.cpp_extension import include_paths, library_paths
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{so.stem}.{os.getpid()}"
    nvcc = _nvcc()
    incs = [f"-I{p}" for p in include_paths(device_type="cuda")]
    compiles, objs = [], []
    for name in CUDA_SOURCES:
        obj = BUILD_DIR / f"{tag}.{name}.o"
        compiles.append([nvcc, *CUDA_FLAGS, "-c", str(CSRC / name),
                         "-o", str(obj)])
        objs.append(str(obj))
    for name in HOST_SOURCES:
        obj = BUILD_DIR / f"{tag}.{name}.o"
        compiles.append([nvcc, *HOST_FLAGS, *incs, "-c", str(CSRC / name),
                         "-o", str(obj)])
        objs.append(str(obj))
    t0 = time.perf_counter()
    outs = _run_all(compiles)
    tmp = BUILD_DIR / f"{tag}.so"
    libdirs = library_paths(device_type="cuda")
    _run_all([[nvcc, *LINK_FLAGS, *objs, "-o", str(tmp),
               *[f"-L{p}" for p in libdirs],
               *[f"-Xlinker=-rpath={p}" for p in libdirs], *LIBS]])
    log = "".join(f"$ {' '.join(cmd)}\n{out}"
                  for cmd, out in zip(compiles, outs))
    so.with_suffix(".log").write_text(log)
    os.replace(tmp, so)  # atomic: a concurrent build sees all or nothing
    for obj in objs:
        os.remove(obj)
    if verbose:
        print(log, end="")
        print(f"built {so.name} in {time.perf_counter() - t0:.1f} s")
    return so


def build_log() -> str:
    """What the compiles of the current library printed."""
    return library_path().with_suffix(".log").read_text()


def load_ops(verbose: bool = False):
    """Build (at first use) and load the library; returns the
    ``torch.ops.xgan_torch`` namespace."""
    with _load_lock:
        if _failed:
            raise RuntimeError("the xgan_torch kernels failed to build "
                               "earlier in this process") from _failed[0]
        if not _loaded:
            try:
                so = build(verbose=verbose)
            except RuntimeError as e:
                _failed.append(e)
                raise
            torch.ops.load_library(str(so))
            from xgan_torch.kernels.convt import register_fakes
            register_fakes()
            _loaded.append(so)
    return torch.ops.xgan_torch
