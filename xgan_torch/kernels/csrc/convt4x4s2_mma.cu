// Fused ConvTranspose2d(k=4, s=2, p=1) + per-channel affine + activation,
// NHWC, bf16, on the tensor cores through mma.sync (the Ampere-style
// path, sm_90a).
//
// Replaces the Pallas TPU kernel xgan/ops/pallas/convt.py:convt4x4s2_fused
// (body _kernel, pallas_call at convt.py:101) on the bf16 route for the
// shapes that neither warpgroup design takes (xgan_torch/kernels/convt.py:
// convt_route): Cin % 32 == 0 with Cout < 32 where no band fits (Cin above
// 64, e.g. 512 -> 3 or 512 -> 8) or Cout >= 32 not a multiple of 8 (e.g.
// 36). No layer of either G-224 ladder runs here any more: their wide
// layers run on convt4x4s2_wgmma.cu and their narrow ones on
// convt4x4s2_band.cu. chip_smoke.py still times this kernel on
// every ladder layer beside the design that replaced it, and the card
// tests call it at its own shapes. f32 and Cin % 32 != 0 stay on the
// CUDA-core kernel of convt4x4s2.cu. It computes the same function:
// output pixel (2t+py, 2s+px) is the sum over j0, j1 in {0, 1} of
// x[b, t-1+py+j0, s-1+px+j1, :] @ wp[py,px,j0,j1] (zero outside the image),
// taken in f32, then act(acc * scale + shift) in f32, rounded once to
// bf16. Weights arrive phase-major, wp[py][px][j0][j1][Cin][Cout]
// (xgan_torch/kernels/convt.py:pack_convt_weight).
//
// What bounds it on this card (G-224 ladder, batch 64, bf16, H100 SXM at
// 989 TFLOP/s and 3.35 TB/s): layers 1-3 (7->14, 14->28, 28->56) are bound
// by operations, 13.15 GFLOP each (0.0133 ms); layer 4 (56->112, 64->32)
// and layer 5 (112->224, 32->3) are bound by bytes (77 and 71 MB). It
// reached 187-226 TFLOP/s on the wide layers and 7-14x the byte bound on
// the narrow ones (PERF.md): mma.sync is not the card's full tensor-core
// rate, and x is read again for each of the four phases and taps.
//
// Design: an implicit GEMM per output phase (py, px). M = B*H*W output
// pixels of that phase, N = Cout, K = 4*Cin with the taps (j0, j1)
// outermost and Cin inside. Grid (ceil(M/128), ceil(Cout/BN), 4 phases);
// a block of 4 warps computes a 128 x BN tile, BN in {8, 32, 64, 128}
// (xgan_torch/kernels/convt.py:mma_tiles picks it from Cout).
// - Loads: Cin % 32 == 0, so a K-chunk of 32 lies inside one tap and each
//   A row of a chunk is 64 contiguous bytes of one input pixel: four
//   16-byte cp.async.cg with the src-size operand 0 (zero fill, from a
//   valid address) for a pixel outside the image or a row past M. B is the
//   (32 x BN) slice of wp[py,px,j0,j1], N contiguous: 16-byte cp.async
//   where Cout % 8 == 0, scalar zero-filled loads otherwise (Cout = 3).
//   Columns >= Cout are 0.
// - A ring of 3 stages (cp.async.commit_group / wait_group 1) keeps two
//   K-chunks in flight while the warps multiply the third.
// - ldmatrix.x4 (A) and ldmatrix.x4.trans / .x2.trans (B, K-major) feed
//   mma.sync.m16n8k16 bf16 -> f32, with the sums in registers. The shared
//   rows are padded by 16 bytes (A: 80 B a row; B: 2*BN+16 B, BN = 8
//   unpadded at 16 B a row), so the 8 rows of an 8x8 ldmatrix fall in 8
//   different 16-byte bank groups: no bank conflicts, and no swizzle.
// - Epilogue: each thread applies scale/shift/act to its accumulator
//   fragment in f32, rounds to bf16 and writes out[b, 2t+py, 2s+px, n]
//   directly (bf16x2 stores where Cout is even). Each output element
//   belongs to one phase and one tile, so it is written exactly once and
//   the phase interleave costs no pass.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "tensor_core.cuh"

namespace {

using namespace xgan_tc;

constexpr int BM = 128, BK = 32, STAGES = 3, THREADS = 128;
constexpr int A_LD = BK + 8;  // bf16 per A row in shared memory (80 B)

template <int BN>
struct Tile {
  static constexpr int B_LD = BN == 8 ? 8 : BN + 8;  // bf16 per B row
  static constexpr int WARPS_N = BN >= 64 ? 2 : 1;
  static constexpr int WARPS_M = 4 / WARPS_N;
  static constexpr int WM = BM / WARPS_M, WN = BN / WARPS_N;
  static constexpr int MI = WM / 16, NI = WN / 8;  // mma tiles of a warp
  static constexpr int A_STAGE = BM * A_LD, B_STAGE = BK * B_LD;
  static constexpr int SMEM_BYTES = STAGES * (A_STAGE + B_STAGE) * 2;
};

constexpr int A_ROWS = BM * BK / 8 / THREADS;  // 16-byte A copies a thread

__device__ __forceinline__ void ldsm_x4_trans(uint32_t addr, uint32_t& r0,
                                              uint32_t& r1, uint32_t& r2,
                                              uint32_t& r3) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, "
      "[%4];\n"
      : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
      : "r"(addr));
}

__device__ __forceinline__ void ldsm_x2_trans(uint32_t addr, uint32_t& r0,
                                              uint32_t& r1) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, [%2];\n"
      : "=r"(r0), "=r"(r1)
      : "r"(addr));
}

// d += a (16x16, row) * b (16x8, col), bf16 in, f32 sums
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

template <int BN>
__global__ void __launch_bounds__(THREADS)
convt4x4s2_mma_kernel(const __nv_bfloat16* __restrict__ x,
                      const __nv_bfloat16* __restrict__ wp,
                      const float* __restrict__ scale,
                      const float* __restrict__ shift,
                      __nv_bfloat16* __restrict__ out, int B, int H, int W,
                      int Cin, int Cout, int act) {
  using T = Tile<BN>;
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* sA = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* sB = sA + STAGES * T::A_STAGE;

  const int HW = H * W, M = B * HW;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const int phase = blockIdx.z, py = phase >> 1, px = phase & 1;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int chunks_per_tap = Cin / BK, KT = 4 * chunks_per_tap;
  const bool vec_b = Cout % 8 == 0;

  // This thread's A copies: 16-byte column a_col of tile rows
  // a_row + 32*i. a_pix: the input pixel of tap (0,0) of that row;
  // a_taps bit 4*i + (2*j0 + j1): tap (j0, j1) lies inside the image
  // (never set for a row past M).
  const int a_row = tid >> 2, a_col = (tid & 3) * 8;
  int a_pix[A_ROWS];
  unsigned a_taps = 0;
#pragma unroll
  for (int i = 0; i < A_ROWS; ++i) {
    const int row = m0 + a_row + 32 * i;
    const int b = row / HW, r = row - b * HW, t = r / W, s = r - t * W;
    const int iy0 = t - 1 + py, ix0 = s - 1 + px;
    a_pix[i] = (b * H + iy0) * W + ix0;
    if (row < M) {
#pragma unroll
      for (int tap = 0; tap < 4; ++tap) {
        const int iy = iy0 + (tap >> 1), ix = ix0 + (tap & 1);
        if (iy >= 0 && iy < H && ix >= 0 && ix < W)
          a_taps |= 1u << (4 * i + tap);
      }
    }
  }

  // K-chunk kt (tap kt / chunks_per_tap, channels ci0..ci0+31) -> slot
  auto load_chunk = [&](int kt, int slot) {
    const int tap = kt / chunks_per_tap;
    const int ci0 = (kt - tap * chunks_per_tap) * BK;
    const int dpix = (tap >> 1) * W + (tap & 1);
    __nv_bfloat16* sa = sA + slot * T::A_STAGE;
#pragma unroll
    for (int i = 0; i < A_ROWS; ++i) {
      const bool ok = (a_taps >> (4 * i + tap)) & 1u;
      const __nv_bfloat16* src =
          ok ? x + (int64_t)(a_pix[i] + dpix) * Cin + ci0 + a_col : x;
      cp_async16(smem_addr(sa + (a_row + 32 * i) * A_LD + a_col), src, ok);
    }
    const __nv_bfloat16* wk =
        wp + ((int64_t)(phase * 4 + tap) * Cin + ci0) * Cout + n0;
    __nv_bfloat16* sb = sB + slot * T::B_STAGE;
    if (vec_b) {
      constexpr int PER_ROW = BN / 8;
      for (int c = tid; c < BK * PER_ROW; c += THREADS) {
        const int k = c / PER_ROW, col = (c % PER_ROW) * 8;
        const bool ok = n0 + col < Cout;
        cp_async16(smem_addr(sb + k * T::B_LD + col),
                   ok ? wk + (int64_t)k * Cout + col : wp, ok);
      }
    } else {
      for (int e = tid; e < BK * BN; e += THREADS) {
        const int k = e / BN, col = e % BN;
        sb[k * T::B_LD + col] = n0 + col < Cout
                                    ? wk[(int64_t)k * Cout + col]
                                    : __float2bfloat16(0.f);
      }
    }
  };

  float acc[T::MI][T::NI][4];
#pragma unroll
  for (int mi = 0; mi < T::MI; ++mi)
#pragma unroll
    for (int nj = 0; nj < T::NI; ++nj)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[mi][nj][q] = 0.f;

  // One commit per chunk slot, empty past KT, so wait_group 1 always
  // means "chunk kt has landed".
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < KT) load_chunk(s, s);
    cp_async_commit();
  }

  const int wm = warp / T::WARPS_N, wn = warp % T::WARPS_N;
  // ldmatrix row addresses: lanes 8q..8q+7 give the rows of matrix q
  const int ld_r = (lane & 7) + ((lane >> 3) & 1) * 8;  // 0..15
  const int ld_hi = lane >> 4;                          // 0 or 1
  for (int kt = 0; kt < KT; ++kt) {
    cp_async_wait<STAGES - 2>();
    // chunk kt is visible to all; every warp is done with chunk kt-1,
    // whose slot the prefetch below refills
    __syncthreads();
    if (kt + STAGES - 1 < KT)
      load_chunk(kt + STAGES - 1, (kt + STAGES - 1) % STAGES);
    cp_async_commit();

    const __nv_bfloat16* sa = sA + (kt % STAGES) * T::A_STAGE;
    const __nv_bfloat16* sb = sB + (kt % STAGES) * T::B_STAGE;
#pragma unroll
    for (int ks = 0; ks < BK; ks += 16) {
      uint32_t a[T::MI][4], b[T::NI][2];
#pragma unroll
      for (int mi = 0; mi < T::MI; ++mi) {
        // matrices: rows 0-7 | 8-15 of k 0-7, then of k 8-15
        const int row = wm * T::WM + mi * 16 + ld_r;
        ldsm_x4(smem_addr(sa + row * A_LD + ks + ld_hi * 8), a[mi]);
      }
      if constexpr (T::NI == 1) {
        ldsm_x2_trans(smem_addr(sb + (ks + ld_r) * T::B_LD + wn * T::WN),
                      b[0][0], b[0][1]);
      } else {
#pragma unroll
        for (int nj = 0; nj < T::NI; nj += 2) {
          // matrices: k 0-7 | 8-15 of n-tile nj, then of n-tile nj+1
          const int n = wn * T::WN + (nj + ld_hi) * 8;
          ldsm_x4_trans(smem_addr(sb + (ks + ld_r) * T::B_LD + n), b[nj][0],
                        b[nj][1], b[nj + 1][0], b[nj + 1][1]);
        }
      }
#pragma unroll
      for (int mi = 0; mi < T::MI; ++mi)
#pragma unroll
        for (int nj = 0; nj < T::NI; ++nj)
          mma_bf16(acc[mi][nj], a[mi], b[nj][0], b[nj][1]);
    }
  }

  // Epilogue. Fragment element q of acc[mi][nj] is row g + 8*(q >> 1),
  // column c2 + (q & 1) of that 16x8 tile.
  const int g = lane >> 2, c2 = (lane & 3) * 2;
  const bool even = Cout % 2 == 0;
  const float neg = act_slope(act);
  int o_pix[T::MI][2];  // output element offset of each row, -1 past M
#pragma unroll
  for (int mi = 0; mi < T::MI; ++mi)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = m0 + wm * T::WM + mi * 16 + g + 8 * h;
      const int b = row / HW, r = row - b * HW, t = r / W, s = r - t * W;
      o_pix[mi][h] =
          row < M ? ((b * 2 * H + 2 * t + py) * 2 * W + 2 * s + px) * Cout
                  : -1;
    }
#pragma unroll
  for (int nj = 0; nj < T::NI; ++nj) {
    const int col = n0 + wn * T::WN + nj * 8 + c2;
    if (col >= Cout) continue;
    const bool two = col + 1 < Cout;
    const float sc0 = scale[col], sh0 = shift[col];
    const float sc1 = two ? scale[col + 1] : 0.f;
    const float sh1 = two ? shift[col + 1] : 0.f;
#pragma unroll
    for (int mi = 0; mi < T::MI; ++mi)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        if (o_pix[mi][h] < 0) continue;
        __nv_bfloat16* o = out + o_pix[mi][h] + col;
        const float v0 = epilogue(acc[mi][nj][2 * h], sc0, sh0, neg);
        const float v1 = epilogue(acc[mi][nj][2 * h + 1], sc1, sh1, neg);
        if (even) {
          *reinterpret_cast<__nv_bfloat162*>(o) = __floats2bfloat162_rn(v0, v1);
        } else {
          o[0] = __float2bfloat16(v0);
          if (two) o[1] = __float2bfloat16(v1);
        }
      }
  }
}

template <int BN>
cudaError_t launch(const void* x, const void* wp, const float* scale,
                   const float* shift, void* out, int B, int H, int W,
                   int Cin, int Cout, int act, cudaStream_t stream) {
  constexpr int smem = Tile<BN>::SMEM_BYTES;
  // set on every launch: the attribute belongs to the current device
  cudaError_t err = cudaFuncSetAttribute(
      convt4x4s2_mma_kernel<BN>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return err;
  const int M = B * H * W;
  const dim3 grid((M + BM - 1) / BM, (Cout + BN - 1) / BN, 4);
  convt4x4s2_mma_kernel<BN><<<grid, THREADS, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(x),
      static_cast<const __nv_bfloat16*>(wp), scale, shift,
      static_cast<__nv_bfloat16*>(out), B, H, W, Cin, Cout, act);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point, called by the op's host code in convt_op.cpp, which
// has checked the arguments (bf16, Cin % 32 == 0, 16-byte aligned
// pointers, block_n in {8, 32, 64, 128}). Launches on ``stream``; it
// neither synchronises nor allocates. Returns the status of the launch
// (or of the shared-memory attribute call before it), which the caller
// turns into an error.
extern "C" int xgan_convt4x4s2_mma_launch(
    const void* x, const void* wp, const float* scale, const float* shift,
    void* out, int B, int H, int W, int Cin, int Cout, int act, int block_n,
    cudaStream_t stream) {
  switch (block_n) {
    case 8:
      return launch<8>(x, wp, scale, shift, out, B, H, W, Cin, Cout, act,
                       stream);
    case 32:
      return launch<32>(x, wp, scale, shift, out, B, H, W, Cin, Cout, act,
                        stream);
    case 64:
      return launch<64>(x, wp, scale, shift, out, B, H, W, Cin, Cout, act,
                        stream);
    case 128:
      return launch<128>(x, wp, scale, shift, out, B, H, W, Cin, Cout, act,
                         stream);
    default:
      return cudaErrorInvalidValue;
  }
}
