"""Fused ConvTranspose2d(k4,s2,p1) + per-channel affine + activation.

Counterpart of the Pallas TPU kernel ``xgan/ops/pallas/convt.py:
convt4x4s2_fused``. ``x (B,H,W,Cin)`` NHWC -> ``(B,2H,2W,Cout)`` in
``x.dtype``; the sum is taken in f32, then ``act(acc * scale + shift)``
with f32 ``(Cout,)`` scale/shift (eval BN folded in, see
``xgan_torch.ops.norm.fold_bn``) and ``act`` in none | relu |
leaky_relu (slope 0.2).

The weight is a torch ConvTranspose2d weight ``(Cin, Cout, 4, 4)``
repacked once by :func:`pack_convt_weight` into phase-major
``(2,2,2,2,Cin,Cout)``: output pixel (2t+py, 2s+px) sums
``x[t-1+py+j0, s-1+px+j1] @ wp[py,px,j0,j1]`` over j0, j1 in {0, 1}
(zero outside the image), with ``wp[py,px,j0,j1] = W[:, :,
3-py-2*j0, 3-px-2*j1]`` -- the mirror of the TPU kernel's ``sel`` on its
spatially flipped HWIO weight.

:func:`convt4x4s2_fused` runs a CUDA kernel on a CUDA tensor and the
plain version :func:`convt4x4s2_fused_ref` on a CPU tensor. The kernel is
chosen by dtype and shape before the launch, by one rule
(:func:`convt_route`). bf16 with Cin % 32 == 0 runs on the tensor cores
(:func:`uses_mma`), in one of three designs:

- ``wgmma`` (``csrc/convt4x4s2_wgmma.cu``): warpgroup products, 128 x
  block_n tiles of one output phase; Cout % 8 == 0 and Cout >= 32 (the
  wide layers of both G-224 ladders);
- ``band`` (``csrc/convt4x4s2_band.cu``): all four phases from one band
  of input rows in shared memory; Cin 32 or 64, Cout <= 32 where a band
  fits (the narrow layers);
- ``mma`` (``csrc/convt4x4s2_mma.cu``): the ``mma.sync`` implicit GEMM
  (tiles from :func:`mma_tiles`), for the other bf16 shapes.

Everything else goes to the CUDA-core kernel (``csrc/convt4x4s2.cu``). A
failed build or launch raises; no route falls back to another.
:func:`convt4x4s2_mma_emulate`, :func:`convt4x4s2_wgmma_emulate` and
:func:`convt4x4s2_band_emulate` walk the tensor-core kernels' grids on
the CPU, so their index arithmetic and shared-memory layouts are tested
without a card.

:func:`convt4x4s2_train` is the differentiable form that the train-mode
generator calls: its forward is one :func:`convt4x4s2_fused` call.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

from xgan_torch import kernels
from xgan_torch.utils.cache import per_device

ACTS = {"none": 0, "relu": 1, "leaky_relu": 2}

# ky (or kx) of the torch weight feeding phase p through tap j: 3 - p - 2j
_TAP = torch.tensor([[3, 1], [2, 0]])


@per_device
def _tap(device: torch.device) -> torch.Tensor:
    """``_TAP`` on ``device``, copied there once."""
    return _TAP.to(device)


def _act_code(act: str) -> int:
    if act not in ACTS:
        raise ValueError(f"act must be one of {sorted(ACTS)}, got {act!r}")
    return ACTS[act]


def _act(y: torch.Tensor, code: int) -> torch.Tensor:
    """The epilogue's activation of ``y`` for an ``ACTS`` code."""
    if code == 1:
        return torch.relu(y)
    if code == 2:
        return torch.where(y >= 0, y, 0.2 * y)
    return y


def pack_convt_weight(w: torch.Tensor,
                      dtype: torch.dtype | None = None) -> torch.Tensor:
    """torch ConvTranspose2d weight (Cin, Cout, 4, 4) -> contiguous
    phase-major (2, 2, 2, 2, Cin, Cout) ``[py, px, j0, j1]``."""
    if w.dim() != 4 or tuple(w.shape[2:]) != (4, 4):
        raise ValueError(f"expected a (Cin, Cout, 4, 4) weight, got "
                         f"{tuple(w.shape)}")
    tap = _tap(w.device)
    wk = w.permute(2, 3, 0, 1)  # (ky, kx, Cin, Cout)
    wp = wk[tap[:, None, :, None], tap[None, :, None, :]]
    return wp.to(dtype or w.dtype).contiguous()


def convt4x4s2_fused_ref(x, wp, scale, shift, act: str = "none"):
    """Plain torch version: four phase sums as einsums over slices of the
    1-px-padded input, the epilogue in f32 (f64 for f64 inputs, so that
    gradients can be checked numerically), then the interleave."""
    code = _act_code(act)
    b, h, w, _ = x.shape
    acc = torch.promote_types(x.dtype, torch.float32)
    xp = F.pad(x.to(acc), (0, 0, 1, 1, 1, 1))
    w32 = wp.to(acc)
    rows = []
    for py in (0, 1):
        cols = []
        for px in (0, 1):
            y = sum(torch.einsum(
                "bhwc,cd->bhwd",
                xp[:, py + j0:py + j0 + h, px + j1:px + j1 + w, :],
                w32[py, px, j0, j1]) for j0 in (0, 1) for j1 in (0, 1))
            cols.append(_act(y * scale.to(acc) + shift.to(acc), code))
        rows.append(torch.stack(cols, dim=-2))  # (B, H, W, px, C)
    y = torch.stack(rows, dim=2)  # (B, H, py, W, px, C)
    return y.reshape(b, 2 * h, 2 * w, -1).to(x.dtype)


class MmaTiles(NamedTuple):
    """Tile configuration of the tensor-core kernel: a block computes a
    ``block_m x block_n`` output tile of one phase, taking K in chunks of
    ``block_k``. block_m and block_k are the kernel's constants BM and BK
    (``csrc/convt4x4s2_mma.cu``); block_n is its template parameter."""
    block_m: int
    block_n: int
    block_k: int


MMA_BLOCK_NS = (8, 32, 64, 128)


def mma_tiles(cin: int, cout: int) -> MmaTiles:
    """The one tile configuration per (Cin, Cout): the smallest block_n
    of :data:`MMA_BLOCK_NS` that covers Cout, 128 above that (Cout then
    takes ceil(Cout / 128) n-tiles)."""
    del cin  # K is walked in chunks of 32 whatever Cin is
    block_n = next((n for n in MMA_BLOCK_NS if n >= cout), MMA_BLOCK_NS[-1])
    return MmaTiles(128, block_n, 32)


def uses_mma(dtype: torch.dtype, cin: int) -> bool:
    """Whether a CUDA input of this dtype and Cin runs on the tensor cores
    (one of :func:`convt_route`'s wgmma, band and mma designs), else on
    the CUDA-core kernel."""
    return dtype == torch.bfloat16 and cin > 0 and cin % 32 == 0


def convt4x4s2_mma_emulate(x, wp, scale, shift, act: str = "none",
                           tiles: MmaTiles | None = None):
    """CPU emulation of ``csrc/convt4x4s2_mma.cu``: the same grid walked in
    the same order, (m-tile, n-tile, phase) and then the K-chunks (tap,
    Cin-chunk) of each; the same row -> (b, t, s) and (tap, row) -> input
    pixel arithmetic; zero fill for pixels outside the image, rows past M
    and columns past Cout; f32 sums; the epilogue and the one rounding to
    ``x.dtype`` at the store. Raises if an output element is not written
    exactly once."""
    code = _act_code(act)
    b, h, w, cin = x.shape
    cout = wp.shape[-1]
    tiles = tiles or mma_tiles(cin, cout)
    bm, bn, bk = tiles.block_m, tiles.block_n, tiles.block_k
    if cin % bk:
        raise ValueError(f"Cin={cin} is not a multiple of block_k={bk}")
    hw = h * w
    m = b * hw
    chunks_per_tap = cin // bk
    xf = x.reshape(-1, cin)
    wf = wp.reshape(4, 4, cin, cout)  # [phase, tap]
    out = torch.zeros(b * 4 * hw * cout, dtype=x.dtype)
    writes = torch.zeros(b * 4 * hw * cout, dtype=torch.int32)
    for m_tile in range(math.ceil(m / bm)):
        for n_tile in range(math.ceil(cout / bn)):
            for phase in range(4):
                py, px = phase >> 1, phase & 1
                rows = m_tile * bm + torch.arange(bm)
                bi = rows // hw
                r = rows - bi * hw
                t = r // w
                s = r - t * w
                iy0, ix0 = t - 1 + py, s - 1 + px
                pix0 = (bi * h + iy0) * w + ix0
                taps = [(rows < m) & (iy0 + j0 >= 0) & (iy0 + j0 < h)
                        & (ix0 + j1 >= 0) & (ix0 + j1 < w)
                        for j0 in (0, 1) for j1 in (0, 1)]
                cols = n_tile * bn + torch.arange(bn)
                col_ok = cols < cout
                acc = torch.zeros(bm, bn)
                for kt in range(4 * chunks_per_tap):
                    tap, chunk = divmod(kt, chunks_per_tap)
                    ci0 = chunk * bk
                    ok = taps[tap]
                    pix = torch.where(ok, pix0 + (tap >> 1) * w + (tap & 1), 0)
                    a = torch.where(ok[:, None],
                                    xf[pix, ci0:ci0 + bk].float(), 0.0)
                    bmat = torch.zeros(bk, bn)
                    bmat[:, col_ok] = wf[phase, tap, ci0:ci0 + bk,
                                         cols[col_ok]].float()
                    acc += a @ bmat
                # epilogue: rows past M and columns past Cout not stored
                row_ok = rows < m
                n = cols[col_ok]
                y = _act(acc[row_ok][:, col_ok] * scale.float()[n]
                         + shift.float()[n], code)
                opix = ((bi * 2 * h + 2 * t + py) * 2 * w + 2 * s + px) * cout
                idx = opix[row_ok][:, None] + n[None, :]
                out[idx] = y.to(x.dtype)
                writes[idx] += 1
    if not (writes == 1).all():
        raise RuntimeError("convt4x4s2_mma_emulate: an output element was "
                           "not written exactly once")
    return out.reshape(b, 2 * h, 2 * w, cout)


class Route(NamedTuple):
    """Where a CUDA input runs, chosen before the launch: ``design`` is
    ``"wgmma"``, ``"band"`` or ``"mma"`` (tensor cores, bf16) or ``"core"``
    (CUDA cores); ``block_n`` the tile width (wgmma, mma) or Cout padded
    with zero columns (band: 4, 8 or 32), 0 for core; ``rows`` the input
    rows of a band (band), else 0."""
    design: str
    block_n: int
    rows: int


WGMMA_BLOCK_NS = (32, 64, 128, 256)
WGMMA_BLOCK_M, WGMMA_BLOCK_K = 128, 64  # csrc/convt4x4s2_wgmma.cu BM, BK
BAND_CINS = (32, 64)
SMEM_BYTES = 232448  # shared memory an H100 block may use

def band_np(cout: int) -> int:
    """Cout padded with zero columns to the band kernel's NP: 4, 8 (the
    four phases in one product of 4 * NP columns) or 32 (a product a
    phase)."""
    return 4 if cout <= 4 else 8 if cout <= 8 else 32


def band_width(cout: int) -> int:
    """Columns of the band kernel's products: 4 * NP, or 32."""
    np_ = band_np(cout)
    return 4 * np_ if np_ <= 8 else 32


def band_slabs(cout: int) -> int:
    """The band kernel's m64 slabs a band at most, as the accumulators'
    registers allow: 8 with the phases in one product (four a
    warpgroup), 2 with a product a phase."""
    return 8 if band_np(cout) <= 8 else 2


def band_smem(w: int, cin: int, cout: int, rows: int) -> int:
    """Shared memory of a band block: the weight's 9 (phases in one
    product) or 16 slices of Cin x :func:`band_width` columns, two bands
    of rows + 2 padded input rows, 1 KB of alignment slack."""
    slices = 9 if band_np(cout) <= 8 else 16
    return slices * cin * band_width(cout) * 2 \
        + 2 * (rows + 2) * (w + 2) * cin * 2 + 1024


def band_rows(h: int, w: int, cin: int, cout: int) -> int:
    """The most input rows a band block can hold at this shape, 0 if none:
    ``rows * W`` pixels within its m64 slabs (:func:`band_slabs`), its
    shared memory within a block's, and the band's output span (staged in
    the band's space) no larger than the band."""
    if cin not in BAND_CINS or not 1 <= cout <= 32:
        return 0
    for rows in range(min(h, band_slabs(cout) * 64 // w), 0, -1):
        if (band_smem(w, cin, cout, rows) <= SMEM_BYTES
                and 4 * rows * w * cout <= (rows + 2) * (w + 2) * cin):
            return rows
    return 0


def wgmma_block_n(cout: int) -> int:
    """The rule's block_n for the wgmma route: the smallest of
    :data:`WGMMA_BLOCK_NS` that covers Cout, 256 above that."""
    return next((n for n in WGMMA_BLOCK_NS if n >= cout), WGMMA_BLOCK_NS[-1])


def convt_route(dtype: torch.dtype, h: int, w: int, cin: int,
                cout: int) -> Route:
    """The kernel of a CUDA input (B, H, W, Cin) with Cout outputs. For
    bf16 with Cin % 32 == 0: the band kernel for Cout <= 32 where a band
    fits, the wgmma kernel for Cout % 8 == 0 and Cout >= 32, the mma.sync
    kernel otherwise; the CUDA-core kernel for f32 and other Cin. The rule
    was chosen by timing every candidate at the layers of both G-224
    ladders on an H100 at B = 64 and 128 (PERF.md §6)."""
    if not uses_mma(dtype, cin):
        return Route("core", 0, 0)
    rows = band_rows(h, w, cin, cout)
    if cout <= 32 and rows:
        return Route("band", band_np(cout), rows)
    if cout >= 32 and cout % 8 == 0:
        return Route("wgmma", wgmma_block_n(cout), 0)
    return Route("mma", mma_tiles(cin, cout).block_n, 0)


def _swizzle(addr: torch.Tensor, layout: int) -> torch.Tensor:
    """Shared-memory byte addresses after the hardware swizzle of a wgmma
    descriptor layout (1: 128-byte, bits 4-6 ^= bits 7-9; 2: 64-byte, bits
    4-5 ^= bits 7-8; 3: 32-byte, bit 4 ^= bit 7)."""
    mask = {1: 7, 2: 3, 3: 1}[layout]
    return addr ^ (((addr >> 7) & mask) << 4)


def _mn_major_b(smem: torch.Tensor, start: int, lbo: int, sbo: int,
                layout: int, n: int) -> torch.Tensor:
    """The 16 x n B operand that a register-A wgmma k16 step with
    imm-trans-b = 1 reads through a descriptor (start, LBO, SBO, layout)
    from ``smem`` (elements of 2 bytes at byte address / 2), by the PTX
    ISA's MN-major canonical layouts with a 128-, 64- or 32-byte swizzle
    (layout 1, 2, 3): atoms of 64, 32 or 16 columns, K rows of that many
    columns 128, 64 or 32 B apart, 8 rows to SBO, atoms LBO apart."""
    atom = {1: 64, 2: 32, 3: 16}[layout]
    k = torch.arange(16)[:, None]
    col = torch.arange(n)[None, :]
    addr = (col // atom) * lbo + (k // 8) * sbo + (k % 8) * atom * 2 \
        + (col % atom) * 2
    return smem[_swizzle(start + addr, layout) // 2]


def _ldmatrix_a(smem: torch.Tensor, lane_addr: torch.Tensor) -> torch.Tensor:
    """The 16 x 16 A fragment of one warp that ``ldmatrix.x4`` gives from
    the 32 lanes' row addresses (bytes): lanes 8q..8q+7 address the 8
    rows of matrix q, and matrices 0-3 are rows 0-7 | 8-15 of k 0-7, then
    of k 8-15 (the m16n8k16 A registers a0-a3)."""
    rows = smem[(lane_addr[:, None] // 2) + torch.arange(8)[None, :]]
    m = rows.reshape(4, 8, 8)  # [matrix, row, k]
    return torch.cat([torch.cat([m[0], m[2]], 1), torch.cat([m[1], m[3]], 1)])


def _accumulator_rc(n: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(row, column) in the 64 x n f32 accumulator of a wgmma m64nNk16 of
    register i of thread t of the warpgroup, as (128, n/2) tensors: the
    PTX ISA's layout, thread t = t0 + 4 t1 + 32 t2 and i = v0 + 2 v1 +
    4 v2 at row t1 + 16 t2 + 8 v1, column 2 t0 + v0 + 8 v2."""
    t = torch.arange(128)[:, None]
    i = torch.arange(n // 2)[None, :]
    t0, t1, t2 = t % 4, (t // 4) % 8, t // 32
    v0, v1, v2 = i % 2, (i // 2) % 2, i // 4
    return t1 + 16 * t2 + 8 * v1, 2 * t0 + v0 + 8 * v2


def _epilogue_rc(n: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(row, column) in its warpgroup's 64 x n tile where the kernels'
    epilogues put register r of thread t (warp q = t / 32, lane l): row
    16q + l / 4 + 8h, column 8j + 2 (l % 4) + e for r = 4j + 2h + e, as
    (128, n/2) tensors."""
    t = torch.arange(128)[:, None]
    r = torch.arange(n // 2)[None, :]
    q, lane = t // 32, t % 32
    j, h, e = r // 4, (r // 2) % 2, r % 2
    return 16 * q + lane // 4 + 8 * h, 8 * j + 2 * (lane % 4) + e


def convt4x4s2_wgmma_emulate(x, wp, scale, shift, act: str = "none",
                             block_n: int | None = None):
    """CPU emulation of ``csrc/convt4x4s2_wgmma.cu``: the grid (m-tile,
    n-tile, phase) and, in each block, the K-chunks of 64 in order; A as
    the kernel copies it (a 16-byte column of a chunk from tap k // Cin,
    zero for pixels outside the image and rows past M) into 144-byte rows
    and reads it back by each lane's ``ldmatrix`` address; B stored by the
    kernel's swizzled copy addresses and read back through its descriptor
    (:func:`_mn_major_b`); the two m64 slabs' f32 sums; each thread's
    accumulator registers stored by the epilogue's row and column mapping
    after scale/shift/act, rounded once to ``x.dtype``. Raises if an output
    element is not written exactly once."""
    code = _act_code(act)
    b, h, w, cin = x.shape
    cout = wp.shape[-1]
    bn = block_n or wgmma_block_n(cout)
    if cin % 32 or cout % 8 or cout < 32 or bn not in WGMMA_BLOCK_NS:
        raise ValueError(f"no wgmma tile for Cin={cin}, Cout={cout}, "
                         f"block_n={bn}")
    bm, bk = WGMMA_BLOCK_M, WGMMA_BLOCK_K
    a_ld = bk + 8
    atom_n = 64 if bn >= 64 else 32
    row_bytes, layout = atom_n * 2, 1 if bn >= 64 else 2
    rc, atom_bytes = row_bytes // 16, bk * atom_n * 2
    hw, m = h * w, b * h * w
    xf = x.reshape(-1, cin).float()
    wk = wp.reshape(4, 4 * cin, cout).float()  # [phase, tap * Cin + ci]
    out = torch.zeros(b * 4 * hw * cout, dtype=x.dtype)
    writes = torch.zeros(b * 4 * hw * cout, dtype=torch.int32)
    # B's copy addresses: row r, column n of a chunk
    r = torch.arange(bk)[:, None]
    col = torch.arange(bn)[None, :]
    chunk = col // 8
    sw = ((r * row_bytes) >> 7) & (rc - 1)
    b_off = (chunk // rc) * atom_bytes + r * row_bytes \
        + (((chunk % rc) ^ sw) << 4) + (col % 8) * 2
    # the lanes' ldmatrix byte addresses in an A stage, per warp
    lane = torch.arange(32)
    ld_r = (lane & 7) + ((lane >> 3) & 1) * 8
    ld_hi = lane >> 4
    acc_r, acc_c = _accumulator_rc(bn)
    ep_row, ep_col = _epilogue_rc(bn)
    for m_tile in range(math.ceil(m / bm)):
        rows = m_tile * bm + torch.arange(bm)
        bi, rr = rows // hw, rows % hw
        t, s_ = rr // w, rr % w
        for n_tile in range(math.ceil(cout / bn)):
            n0 = n_tile * bn
            cols = n0 + torch.arange(bn)
            for phase in range(4):
                py, px = phase >> 1, phase & 1
                iy0, ix0 = t - 1 + py, s_ - 1 + px
                pix0 = (bi * h + iy0) * w + ix0
                acc = torch.zeros(2, 64, bn)  # the warpgroups' m64 slabs
                for kt in range(4 * cin // bk):
                    # A: 16-byte column c8 holds K index kt*64 + 8*c8
                    a_smem = torch.zeros(bm * a_ld)
                    for c8 in range(bk // 8):
                        k = kt * bk + 8 * c8
                        tap, ci = divmod(k, cin)
                        j0, j1 = tap >> 1, tap & 1
                        ok = ((rows < m) & (iy0 + j0 >= 0) & (iy0 + j0 < h)
                              & (ix0 + j1 >= 0) & (ix0 + j1 < w))
                        pix = torch.where(ok, pix0 + j0 * w + j1, 0)
                        vals = torch.where(ok[:, None], xf[pix, ci:ci + 8],
                                           0.0)
                        dst = (torch.arange(bm)[:, None] * a_ld + 8 * c8
                               + torch.arange(8)[None, :])
                        a_smem[dst] = vals
                    b_smem = torch.zeros(bk * bn)
                    bvals = torch.zeros(bk, bn)
                    ok_n = cols < cout
                    bvals[:, ok_n] = wk[phase, kt * bk:(kt + 1) * bk,
                                        cols[ok_n]]
                    b_smem[b_off // 2] = bvals
                    for wg in range(2):
                        for j in range(bk // 16):
                            a_slab = torch.cat([_ldmatrix_a(
                                a_smem, ((wg * 64 + q * 16 + ld_r) * a_ld
                                         + ld_hi * 8) * 2 + 32 * j)
                                for q in range(4)])
                            bmat = _mn_major_b(b_smem, j * 16 * row_bytes,
                                               atom_bytes, 8 * row_bytes,
                                               layout, bn)
                            acc[wg] += a_slab @ bmat
                # epilogue: register 4j + 2h + e of thread (wg, q, lane) is
                # tile row wg*64 + 16q + g + 8h, column 8j + c2 + e
                for wg in range(2):
                    regs = acc[wg][acc_r, acc_c]  # (128 threads, bn / 2)
                    row = m_tile * bm + wg * 64 + ep_row
                    n = n0 + ep_col
                    keep = (row < m) & (n < cout)
                    row, n, v = row[keep], n[keep], regs[keep]
                    y = _act(v * scale.float()[n] + shift.float()[n], code)
                    rb, rrr = row // hw, row % hw
                    tt, ss = rrr // w, rrr % w
                    idx = ((rb * 2 * h + 2 * tt + py) * 2 * w + 2 * ss
                           + px) * cout + n
                    out[idx] = y.to(x.dtype)
                    writes[idx] += 1
    if not (writes == 1).all():
        raise RuntimeError("convt4x4s2_wgmma_emulate: an output element was "
                           "not written exactly once")
    return out.reshape(b, 2 * h, 2 * w, cout)


def _band_off(p: torch.Tensor, c, cin: int) -> torch.Tensor:
    """Byte offset of 16-byte chunk ``c`` of band pixel ``p`` (the band
    kernel's swizzle: c ^ p % 8 at Cin = 64, c ^ (p / 2) % 4 at 32)."""
    f = (p & 7) if cin == 64 else ((p >> 1) & 3)
    return p * cin * 2 + ((c ^ f) << 4)


def convt4x4s2_band_emulate(x, wp, scale, shift, act: str = "none",
                            rows: int | None = None, grid: int = 3):
    """CPU emulation of ``csrc/convt4x4s2_band.cu``: ``grid`` persistent
    blocks, each walking the work items (image, band of ``rows`` input
    rows) with the grid's stride; the weight stored once by the kernel's
    swizzled addresses (Cout <= 8: 9 slices, one per shift, with the four
    phases' NP columns side by side; else the 16 (phase, tap) slices of 32
    columns) and read through its descriptors; the band's halo rows (zero
    outside the image) and zero columns stored by the kernel's swizzled
    copy addresses; for each m64 slab (of warpgroup slab % 2) and 16
    channels, the kernel's wgmma groups (Cout <= 8: a shift, one product
    a slab; else a tap, one product a phase at its own shift), each A
    fragment read back by each lane's ``ldmatrix`` address, each
    accumulator's first product overwriting it; the epilogue
    into the band's space in output order through each thread's
    accumulator registers; then the band's contiguous output span copied
    out. Cout <= 8: where a sum is NaN, the span computed again from each
    output's own phase and stored directly. Raises if an output element
    is not written exactly once."""
    code = _act_code(act)
    b, h, w, cin = x.shape
    cout = wp.shape[-1]
    rows = rows or band_rows(h, w, cin, cout)
    np_ = band_np(cout)
    combined = np_ <= 8
    if (cin not in BAND_CINS or not 1 <= cout <= 32 or rows < 1
            or rows * w > 64 * band_slabs(cout)
            or 4 * rows * w * cout > (rows + 2) * (w + 2) * cin):
        raise ValueError(f"no band of {rows} rows for W={w}, Cin={cin}, "
                         f"Cout={cout}")
    wn = band_width(cout)
    w_row, layout = 2 * wn, 3 if wn == 16 else 2
    w_slice = cin * w_row
    slices = 9 if combined else 16
    # the weight, once a block (the same in every block): the slices
    # zeroed, then element f = (phase q, tap, ci, c) of wp placed at slice
    # d, row ci, column n
    f = torch.arange(16 * cin * cout)
    qt, r = f // (cin * cout), f % (cin * cout)
    ci, c = r // cout, r % cout
    q, tap = qt >> 2, qt & 3
    if combined:
        d = ((q >> 1) + (tap >> 1)) * 3 + (q & 1) + (tap & 1)
        n = np_ * q + c
    else:
        d, n = qt, c
    wsm = torch.zeros(slices * w_slice // 2)
    sw = ((ci * w_row) >> 7) & (w_row // 16 - 1)
    off = d * w_slice + ci * w_row + (((n >> 3) ^ sw) << 4) + (n & 7) * 2
    wsm[off // 2] = wp.reshape(-1).float()

    def b_desc(slice_, kk):  # the 16 x 32 B of a k16 step of a slice
        return _mn_major_b(wsm, slice_ * w_slice + kk * 16 * w_row, w_slice,
                           8 * w_row, layout, wn)

    xf = x.float()
    w2 = w + 2
    nbands = math.ceil(h / rows)
    lane = torch.arange(32)
    acc_r, acc_c = _accumulator_rc(wn)
    ep_row, ep_col = _epilogue_rc(wn)
    out = torch.zeros(b * 4 * h * w * cout, dtype=x.dtype)
    writes = torch.zeros(b * 4 * h * w * cout, dtype=torch.int32)
    for block in range(grid):
        for item in range(block, b * nbands, grid):
            bi, r0 = item // nbands, (item % nbands) * rows
            nrows = min(rows, h - r0)
            m = nrows * w
            band = torch.full(((rows + 2) * w2 * cin,), float("nan"))
            # the copies: smem row i <- input row r0 - 1 + i, column 1 + s
            for i in range(rows + 2):
                iy = r0 - 1 + i
                s_ = torch.arange(w)
                for ch in range(cin // 8):
                    dst = _band_off(i * w2 + s_ + 1, ch, cin)[:, None] // 2 \
                        + torch.arange(8)[None, :]
                    band[dst] = (xf[bi, iy, :, 8 * ch:8 * ch + 8]
                                 if 0 <= iy < h else 0.0)
                for p in (i * w2, i * w2 + w + 1):  # the zero columns
                    for ch in range(cin // 8):
                        band[_band_off(torch.tensor(p), ch, cin) // 2
                             + torch.arange(8)] = 0.0
            # acc[sl][phase] (64 x 32); combined: one, the four phases'
            # 8 columns side by side
            acc = {}
            for sl in range(math.ceil(m / 64)):
                mm = sl * 64 + torch.arange(4)[:, None] * 16 + (lane & 7) \
                    + ((lane >> 3) & 1) * 8  # (warp % 4, lane)
                t = torch.where(mm < m, mm // w, 0)
                p0 = t * w2 + torch.where(mm < m, mm - t * w, 0)
                phases = [torch.full((64, wn), float("nan"))
                          for _ in range(1 if combined else 4)]
                # a wgmma group: combined, one shift for the warpgroup's
                # slabs (this one's product here); else one tap for the
                # four phases, each at its own shift
                for kk in range(cin // 16):
                    for u in range(9 if combined else 4):
                        for k4 in range(1 if combined else 4):
                            if combined:
                                dy, dx, slice_, k = u // 3, u % 3, u, 0
                            else:
                                dy = (k4 >> 1) + (u >> 1)
                                dx = (k4 & 1) + (u & 1)
                                slice_, k = k4 * 4 + u, k4
                            a = torch.cat([_ldmatrix_a(band, _band_off(
                                p0[q] + dy * w2 + dx, 2 * kk + (lane >> 4),
                                cin)) for q in range(4)])
                            prod = a @ b_desc(slice_, kk)
                            # scale-d 0 on an accumulator's first product
                            phases[k] = prod if kk == u == 0 \
                                else phases[k] + prod
                acc[sl] = phases
            span = 2 * nrows * 2 * w * cout
            dst = (bi * 2 * h + 2 * r0) * 2 * w * cout
            if combined and any(a_k.isnan().any() for phases in acc.values()
                                for a_k in phases):
                # a NaN sum (a zero column times a non-finite input): the
                # span again, each output from its own phase's four taps
                # over the band and the weight slices, stored directly
                e = torch.arange(span)
                nn, ox, oy = e % cout, (e // cout) % (2 * w), \
                    e // (cout * 2 * w)
                t, py, s_, px = oy >> 1, oy & 1, ox >> 1, ox & 1
                col = (np_ * (2 * py + px) + nn)[:, None]
                cis = torch.arange(cin)[None, :]
                sw_ci = ((cis * w_row) >> 7) & (w_row // 16 - 1)
                y = torch.zeros(span)
                for j0 in (0, 1):
                    for j1 in (0, 1):
                        pix = ((t + py + j0) * w2 + s_ + px + j1)[:, None]
                        xs = band[_band_off(pix, cis >> 3, cin) // 2
                                  + (cis & 7)]
                        d = ((py + j0) * 3 + px + j1)[:, None]
                        ws = wsm[(d * w_slice + cis * w_row
                                  + (((col >> 3) ^ sw_ci) << 4)
                                  + (col & 7) * 2) // 2]
                        y = y + (xs * ws).sum(1)
                y = _act(y * scale.float()[nn] + shift.float()[nn], code)
                out[dst:dst + span] = y.to(x.dtype)
                writes[dst:dst + span] += 1
                continue
            # epilogue into the band's space: output row 2t + py, column
            # 2s + px of the span, from thread (warp % 4, lane) register
            # 4j + 2h + e
            stage = torch.full((band.numel(),), float("nan"))
            staged = torch.zeros(band.numel(), dtype=torch.int32)
            for sl, phases in acc.items():
                for k, a_k in enumerate(phases):
                    regs = a_k[acc_r, acc_c]  # (128 threads, 16)
                    mm = sl * 64 + ep_row
                    # combined: column NP * q + c is phase q, channel c
                    ph = ep_col // np_ if combined else torch.full_like(
                        ep_col, k)
                    nn = ep_col % np_ if combined else ep_col
                    keep = (mm < m) & (nn < cout)
                    mm, nn, ph, v = mm[keep], nn[keep], ph[keep], regs[keep]
                    y = _act(v * scale.float()[nn] + shift.float()[nn], code)
                    t, s_ = mm // w, mm % w
                    o = ((2 * t + (ph >> 1)) * 2 * w + 2 * s_
                         + (ph & 1)) * cout + nn
                    stage[o] = y.to(x.dtype).float()
                    staged[o] += 1
            if not (staged[:span] == 1).all():
                raise RuntimeError("convt4x4s2_band_emulate: the span was "
                                   "not staged exactly once")
            out[dst:dst + span] = stage[:span].to(x.dtype)
            writes[dst:dst + span] += 1
    if not (writes == 1).all():
        raise RuntimeError("convt4x4s2_band_emulate: an output element was "
                           "not written exactly once")
    return out.reshape(b, 2 * h, 2 * w, cout)


def convt4x4s2_fused_cuda(x, wp, scale, shift, act: str = "none"):
    """Launch a CUDA kernel, picked by dtype and shape (:func:`convt_route`);
    raises for tensors that are not on CUDA. Every launch counts a
    ``convt4x4s2_fused`` launch; every tensor-core launch, whatever its
    design, a ``convt4x4s2_mma`` launch; the wgmma and band designs also
    count ``convt4x4s2_wgmma`` and ``convt4x4s2_band``."""
    if x.device.type != "cuda":
        raise ValueError(f"convt4x4s2_fused_cuda needs CUDA tensors, got "
                         f"x on {x.device}")
    code = _act_code(act)
    from xgan_torch.kernels.build import load_ops
    ops = load_ops()
    _, h, w, cin = x.shape
    route = convt_route(x.dtype, h, w, cin, wp.shape[-1])
    # while torch.export traces the call it launches nothing: no count
    count = not torch.compiler.is_compiling()
    if route.design == "wgmma":
        out = ops.convt4x4s2_wgmma(x, wp, scale, shift, code, route.block_n)
    elif route.design == "band":
        out = ops.convt4x4s2_band(x, wp, scale, shift, code, route.rows)
    elif route.design == "mma":
        out = ops.convt4x4s2_mma(x, wp, scale, shift, code, route.block_n)
    else:
        out = ops.convt4x4s2_fused(x, wp, scale, shift, code)
    if route.design in ("wgmma", "band"):
        kernels.LAUNCHES[f"convt4x4s2_{route.design}"] += count
    if route.design != "core":
        kernels.LAUNCHES["convt4x4s2_mma"] += count
    kernels.LAUNCHES["convt4x4s2_fused"] += count
    return out


def register_fakes() -> None:
    """Shape functions of the compiled ConvT ops, so that ``torch.export``
    can trace a program that calls them (the ops are declared in C++,
    ``csrc/convt_op.cpp``, without one). Called once, when the library is
    loaded."""
    def out_like(x, wp):
        b, h, w, _ = x.shape
        return x.new_empty((b, 2 * h, 2 * w, wp.shape[-1]))

    torch.library.register_fake("xgan_torch::convt4x4s2_fused")(
        lambda x, wp, scale, shift, act: out_like(x, wp))
    torch.library.register_fake("xgan_torch::convt4x4s2_mma")(
        lambda x, wp, scale, shift, act, block_n: out_like(x, wp))
    torch.library.register_fake("xgan_torch::convt4x4s2_wgmma")(
        lambda x, wp, scale, shift, act, block_n: out_like(x, wp))
    torch.library.register_fake("xgan_torch::convt4x4s2_band")(
        lambda x, wp, scale, shift, act, rows: out_like(x, wp))


def convt4x4s2_fused(x, wp, scale, shift, act: str = "none"):
    """The kernel on a CUDA tensor, the plain version on a CPU tensor."""
    if x.device.type == "cpu":
        return convt4x4s2_fused_ref(x, wp, scale, shift, act)
    return convt4x4s2_fused_cuda(x, wp, scale, shift, act)


class ConvT4x4s2Train(torch.autograd.Function):
    """ConvTranspose2d(k4, s2, p1) of NHWC ``x`` with the torch weight
    ``w (Cin, Cout, 4, 4)``, differentiable in both.

    Forward: ``w`` is packed in ``x.dtype`` and ``convt`` (the fused kernel
    by default) runs with an identity affine and ``act="none"``; train-mode
    BN follows outside. Backward: cuDNN's ``convolution_backward`` on NCHW
    views of the NHWC tensors. The Pallas kernel has no backward either:
    the JAX package takes these gradients from XLA's convolutions
    (``jax.vjp`` of lax ``conv_transpose``), outside any Pallas kernel. The
    weight is cast to ``x.dtype`` for both passes and ``dW`` back to the
    parameter's dtype, as the gradient of flax's cast of its f32 kernel.
    Under tensor parallelism ``w`` is this rank's slice ``(Cin, Cout/N,
    4, 4)`` and ``x`` all Cin channels: the slice is packed as any weight
    and the kernel runs at Cout/N (its route by :func:`convt_route`)."""

    @staticmethod
    def forward(ctx, x, w, convt):
        cout = w.shape[1]
        ones = torch.ones(cout, device=x.device)
        zeros = torch.zeros(cout, device=x.device)
        x = x.contiguous()  # the kernels take dense NHWC
        y = convt(x, pack_convt_weight(w, x.dtype), ones, zeros, act="none")
        ctx.save_for_backward(x, w)
        return y

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        need_x, need_w = ctx.needs_input_grad[:2]
        dx, dw, _ = torch.ops.aten.convolution_backward(
            g.to(x.dtype).permute(0, 3, 1, 2), x.permute(0, 3, 1, 2),
            w.to(x.dtype), None, [2, 2], [1, 1], [1, 1], True, [0, 0], 1,
            [need_x, need_w, False])
        return (dx.permute(0, 2, 3, 1) if need_x else None,
                dw.to(w.dtype) if need_w else None, None)


def convt4x4s2_train(x, w, convt=convt4x4s2_fused):
    """Differentiable ConvT(k4, s2, p1): NHWC ``x``, torch weight ``w``
    ``(Cin, Cout, 4, 4)`` (the f32 parameter) -> ``(B, 2H, 2W, Cout)`` in
    ``x.dtype``. ``convt`` is the forward; a check of the kernel passes
    :func:`convt4x4s2_fused_ref` to run the plain version on the card."""
    return ConvT4x4s2Train.apply(x, w, convt)
