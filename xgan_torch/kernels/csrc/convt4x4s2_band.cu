// Fused ConvTranspose2d(k=4, s=2, p=1) + per-channel affine + activation,
// NHWC, bf16, on Hopper's warpgroup tensor-core instruction (wgmma,
// sm_90a): the narrow layers, all four output phases from one input band.
//
// Replaces the Pallas TPU kernel xgan/ops/pallas/convt.py:convt4x4s2_fused
// (body _kernel, pallas_call at convt.py:101) on the bf16 route for
// Cin in {32, 64} and Cout <= 32 where a band fits, as convt_route sends it
// (xgan_torch/kernels/convt.py:convt_route): the G-224 ladders' last
// layers (DCGAN 32 -> 3 at 112, WGAN-GP 64 -> 3 at 112) and DCGAN layer 4
// (64 -> 32 at 56). Same function as convt4x4s2_wgmma.cu.
//
// What bounds it (batch 64, H100 SXM at 3.35 TB/s): bytes. 64 -> 3 at 112
// moves 122 MB (36.5 us), 32 -> 3 at 112 71 MB (21.1 us), 64 -> 32 at 56
// 77 MB (23.0 us); their operations take a fraction of that. The
// per-phase implicit GEMM (convt4x4s2_mma.cu) reads x once per phase and
// tap from L2 and writes Cout = 3 with 2-byte stores at a 2-pixel stride,
// which held the 64 -> 3 layer at 11.3x its bound.
//
// Design: persistent blocks of two warpgroups (256 threads), each block
// walking work items (image b, band of R input rows) with a stride of the
// grid.
// - The weight, copied into shared memory once per block in the MN-major
//   layout wgmma reads (K rows of 32 or 64 B, the 32- or 64-byte swizzle).
//   Cout <= 8: 9 slices, one per input shift (dy, dx) in {0, 1, 2}^2, of
//   Cin x 4*NP columns (NP = 4 for Cout <= 4, else 8): column NP*q + n is
//   output channel n of phase q = (py, px) through tap (dy - py,
//   dx - px), zero where phase q does not use that shift or n >= Cout.
//   Cout > 8: the 16 (phase, tap) slices, Cin x 32 (zero columns past
//   Cout).
// - The band: input rows r0-1 .. r0+R of image b (zero outside the
//   image), each with a zero column on both sides, (R+2) x (W+2) pixels
//   of Cin channels. Two band buffers: the next item's band is loaded with
//   16-byte cp.async while the current one is multiplied. A pixel's
//   16-byte chunk c is stored at chunk c ^ f(pixel) (f = pixel % 8 at
//   Cin = 64, (pixel / 2) % 4 at Cin = 32), so the eight rows of an
//   ldmatrix 8x8 (eight neighbouring pixels) fall in eight different bank
//   groups.
// - The products: the band's R*W pixels are M, in m64 slabs, the slabs
//   alternating between the two warpgroups. Output phase (py, px), tap
//   (j0, j1) reads the band shifted by (dy, dx) = (py+j0, px+j1): a shift
//   costs only ldmatrix row addresses, and the 16 (phase, tap) pairs use
//   9 shifts, so each A fragment (a slab, 16 channels, one shift) is
//   loaded once. Cout <= 8: one register-A wgmma m64n(4*NP)k16 a shift
//   into one accumulator of the four phases' NP columns each (a product
//   of width 8 has a fixed cost that 4 phases at once share; Cout = 3
//   takes n16, half the work of n32). Cout > 8:
//   m64n32k16 per (phase, tap) into one accumulator per phase. A wgmma
//   group holds 4 products into 4 different accumulators (Cout <= 8: one
//   shift for a warpgroup's 4 slabs; else one tap for the 4 phases, each
//   at its own shift), so that no product waits for the one before it;
//   two A register sets alternate behind wgmma.wait_group 1.
//   Each accumulator's first product overwrites it (scale-d 0): no other
//   instruction writes an accumulator while products are in flight, which
//   would serialise them.
// - Output: the band's 2R output rows are one contiguous span of NHWC.
//   The accumulators go through the epilogue (f32, one bf16 rounding)
//   into shared memory in output order, over the current band's space,
//   which the products no longer need; the span is then written with
//   16-byte stores (2-byte ones where the span is not 16-byte aligned).
// - Non-finite inputs (Cout <= 8): a product's zero columns, the phases
//   that do not use its shift, times an inf or NaN input make NaN in
//   sums the plain version keeps finite or infinite. A band whose sums
//   hold a NaN is computed again, each output as plain f32 sums over its
//   own phase's taps, and stored directly; finite data never takes it.
// Bytes from device memory: x about once (the halo rows of a band are
// the neighbouring bands' rows, read again mostly from L2), the output
// once, the weight once per block.
//
// Left for later (ROADMAP B1): TMA loads of the band behind an mbarrier
// and a producer warp; a backward.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "tensor_core.cuh"

namespace {

using namespace xgan_tc;

constexpr int THREADS = 256;  // two warpgroups
constexpr int NBUF = 2;       // A register sets: wgmma groups in flight

// NP: Cout padded with zero columns, 4 (Cout <= 4), 8 or 32
template <int CIN, int NP>
struct Band {
  // Cout <= 8: the four phases share one product a shift, NP columns each
  static constexpr bool COMBINED = NP <= 8;
  static constexpr int WN = COMBINED ? 4 * NP : 32;  // columns a product
  static constexpr int SLICES = COMBINED ? 9 : 16;
  static constexpr int PHASE_ACCS = COMBINED ? 1 : 4;
  static constexpr int SW = COMBINED ? 4 : 1;  // slabs of a warpgroup
  static constexpr int PIX_CHUNKS = CIN / 8;
  static constexpr int W_ROW_BYTES = WN * 2;  // one K row of a slice
  static constexpr int W_ROW_CHUNKS = W_ROW_BYTES / 16;
  static constexpr int W_SLICE_BYTES = CIN * W_ROW_BYTES;
  static constexpr int W_BYTES = SLICES * W_SLICE_BYTES;
  // 32-byte rows: the 32-byte swizzle (3); 64-byte rows: the 64-byte (2)
  static constexpr uint64_t LAYOUT = WN == 16 ? 3 : 2;
  static_assert(CIN == 32 || CIN == 64, "Cin must be 32 or 64");
  static_assert(NP == 4 || NP == 8 || NP == 32, "NP must be 4, 8 or 32");
};

// where chunk c of band pixel p lies (bytes from the band's start)
template <int CIN>
__device__ __forceinline__ uint32_t band_off(int p, int c) {
  const int f = CIN == 64 ? (p & 7) : ((p >> 1) & 3);
  return p * CIN * 2 + ((c ^ f) << 4);
}

__device__ __forceinline__ void st_shared_b16(uint32_t addr, float v) {
  const __nv_bfloat16 b = __float2bfloat16(v);
  asm volatile("st.shared.b16 [%0], %1;\n" ::"r"(addr),
               "h"(*reinterpret_cast<const unsigned short*>(&b))
               : "memory");
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 b = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&b);
}

__device__ __forceinline__ void st_shared_b32(uint32_t addr, uint32_t v) {
  asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(addr), "r"(v) : "memory");
}

template <int CIN, int NP>
__global__ void __launch_bounds__(THREADS, 1)
convt4x4s2_band_kernel(const __nv_bfloat16* __restrict__ x,
                       const __nv_bfloat16* __restrict__ wp,
                       const float* __restrict__ scale,
                       const float* __restrict__ shift,
                       __nv_bfloat16* __restrict__ out, int B, int H, int W,
                       int Cout, int act, int R) {
  using T = Band<CIN, NP>;
  constexpr int SW = T::SW, KS = CIN / 16;
  extern __shared__ unsigned char smem_raw[];
  __shared__ float s_scale[NP], s_shift[NP];
  const uint32_t raw = smem_addr(smem_raw);
  unsigned char* smem = smem_raw + ((1024 - (raw & 1023)) & 1023);
  const uint32_t sW = smem_addr(smem);
  const int W2 = W + 2;
  const int band_bytes = (R + 2) * W2 * CIN * 2;
  unsigned char* const bands = smem + T::W_BYTES;  // two, band_bytes each

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wg = warp >> 2;
  const int nbands = (H + R - 1) / R, items = B * nbands;

  // the weight, once: zero the slices, then read wp in order (coalesced,
  // a thread's BATCH loads issued before their stores) and place element
  // (phase q, tap, ci, c) at slice d, row ci, column n (swizzled)
  for (int i = tid; i < T::W_BYTES / 16; i += THREADS)
    reinterpret_cast<uint4*>(smem)[i] = make_uint4(0, 0, 0, 0);
  __syncthreads();
  constexpr int BATCH = 8;
  const int w_elems = 16 * CIN * Cout;
  for (int f0 = tid; f0 < w_elems; f0 += THREADS * BATCH) {
    __nv_bfloat16 v[BATCH];
#pragma unroll
    for (int u = 0; u < BATCH; ++u) {
      const int f = f0 + u * THREADS;
      v[u] = f < w_elems ? wp[f] : __float2bfloat16(0.f);
    }
#pragma unroll
    for (int u = 0; u < BATCH; ++u) {
      const int f = f0 + u * THREADS;
      if (f >= w_elems) continue;
      const int qt = f / (CIN * Cout), r = f - qt * CIN * Cout;
      const int ci = r / Cout, c = r - ci * Cout;
      const int q = qt >> 2, tap = qt & 3;
      // COMBINED: the slice of shift (py + j0, px + j1), phase q's columns
      const int d = T::COMBINED ? ((q >> 1) + (tap >> 1)) * 3 + (q & 1) +
                                      (tap & 1)
                                : qt;
      const int n = T::COMBINED ? NP * q + c : c;
      const int sw = ((ci * T::W_ROW_BYTES) >> 7) & (T::W_ROW_CHUNKS - 1);
      *reinterpret_cast<__nv_bfloat16*>(
          smem + d * T::W_SLICE_BYTES + ci * T::W_ROW_BYTES +
          (((n >> 3) ^ sw) << 4) + (n & 7) * 2) = v[u];
    }
  }
  if (tid < NP) {
    s_scale[tid] = tid < Cout ? scale[tid] : 0.f;
    s_shift[tid] = tid < Cout ? shift[tid] : 0.f;
  }
  fence_proxy_async();  // the weight is read by wgmma (async proxy)
  __syncthreads();      // the weight, scale and shift are in place

  // issue the copies of item's band into band buffer dst: smem row i is
  // input row r0 - 1 + i, smem column 1 + s input column s; columns 0 and
  // W + 1 are zero
  auto load_band = [&](int item, unsigned char* dst) {
    const int b = item / nbands, r0 = (item - b * nbands) * R;
    const uint32_t sdst = smem_addr(dst);
    for (int i = 0; i < R + 2; ++i) {  // no division by W in the loop
      const int iy = r0 - 1 + i;
      const bool ok = iy >= 0 && iy < H;
      const __nv_bfloat16* row = x + (int64_t)(b * H + iy) * W * CIN;
      for (int c = tid; c < W * T::PIX_CHUNKS; c += THREADS) {
        const int ch = c % T::PIX_CHUNKS, s = c / T::PIX_CHUNKS;
        cp_async16(sdst + band_off<CIN>(i * W2 + s + 1, ch),
                   ok ? row + s * CIN + ch * 8 : x, ok);
      }
    }
    for (int c = tid; c < (R + 2) * 2 * T::PIX_CHUNKS; c += THREADS) {
      const int ch = c % T::PIX_CHUNKS, e = c / T::PIX_CHUNKS;
      const int p = (e >> 1) * W2 + (e & 1) * (W + 1);
      *reinterpret_cast<uint4*>(dst + band_off<CIN>(p, ch)) =
          make_uint4(0, 0, 0, 0);
    }
  };

  // ldmatrix rows of this lane: slab row (warp % 4) * 16 + ld_r, chunk
  // 2 * kk + ld_hi
  const int ld_r = (warp & 3) * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
  const int ld_hi = lane >> 4;
  const int g = lane >> 2, c2 = (lane & 3) * 2;

  // the epilogue's constants: the act's negative slope; this thread's
  // channels' scale and shift (COMBINED: channels c2 % NP and
  // + 1; else 8j + c2 and + 1); bf16 pairs where Cout is even
  const float neg = act_slope(act);
  constexpr int NSC = T::COMBINED ? 2 : 8;
  float sc[NSC], sh[NSC];
#pragma unroll
  for (int k = 0; k < NSC; ++k) {
    const int n = T::COMBINED ? c2 % NP + k : (k / 2) * 8 + c2 + (k & 1);
    sc[k] = s_scale[n];
    sh[k] = s_shift[n];
  }
  const bool pairs = Cout % 2 == 0;

  if (blockIdx.x < items) load_band(blockIdx.x, bands);
  cp_async_commit();
  int it = 0;
  for (int item = blockIdx.x; item < items; item += gridDim.x, ++it) {
    unsigned char* band = bands + (it & 1) * band_bytes;
    const uint32_t sBand = smem_addr(band);
    // the next item's band loads while this one is multiplied; its buffer
    // was last read by the copy-out that ended the previous iteration
    if (item + gridDim.x < items)
      load_band(item + gridDim.x, bands + ((it + 1) & 1) * band_bytes);
    cp_async_commit();
    cp_async_wait<1>();  // this thread's copies of the current band
    __syncthreads();     // everyone's (and, once, the weight)

    const int b = item / nbands, r0 = (item - b * nbands) * R;
    const int rows = min(R, H - r0);  // input rows of this band
    const int M = rows * W;
    const int slabs = (M + 63) / 64;

    // band pixel of shift (0, 0) for this lane's row in each of this
    // warpgroup's slabs wg + 2i; a row past M, or of a slab past the band,
    // reads pixel 0 (its sums are never stored): every product runs, so
    // that no wgmma sits on a path the compiler must treat as divergent
    int p0[SW];
#pragma unroll
    for (int i = 0; i < SW; ++i) {
      const int m = (wg + 2 * i) * 64 + ld_r;
      const int t = m < M ? m / W : 0, s = m < M ? m - t * W : 0;
      p0[i] = t * W2 + s;
    }
    // acc[i][p]: slab wg + 2i, phase p (COMBINED: all four phases, 8
    // columns each). A wgmma group is 4 products into 4 different
    // accumulators, so that no product waits on the one before it:
    // COMBINED, one shift for the warpgroup's 4 slabs; else one tap for
    // the 4 phases (each its own shift). No zero fill, see the header.
    float acc[SW][T::PHASE_ACCS][T::WN / 2];
    uint32_t a[NBUF][4][4];
    constexpr int GROUPS = T::COMBINED ? 9 : 4;  // shifts or taps
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
#pragma unroll
      for (int u = 0; u < GROUPS; ++u) {
        uint32_t(&ad)[4][4] = a[(kk * GROUPS + u) % NBUF];
#pragma unroll
        for (int k4 = 0; k4 < 4; ++k4) {
          // the A fragment of product k4: COMBINED slab k4 at shift u,
          // else phase k4 = (py, px) through tap u = (j0, j1)
          const int pix = T::COMBINED
                              ? p0[k4 < SW ? k4 : 0] + (u / 3) * W2 + u % 3
                              : p0[0] + ((k4 >> 1) + (u >> 1)) * W2 +
                                    (k4 & 1) + (u & 1);
          ldsm_x4(sBand + band_off<CIN>(pix, 2 * kk + ld_hi), ad[k4]);
        }
#pragma unroll
        for (int i = 0; i < SW; ++i)
#pragma unroll
          for (int p = 0; p < T::PHASE_ACCS; ++p) fence_regs(acc[i][p]);
        wgmma_fence();
#pragma unroll
        for (int k4 = 0; k4 < 4; ++k4) {
          const int slice = T::COMBINED ? u : k4 * 4 + u;
          const uint64_t desc = smem_desc(
              sW + slice * T::W_SLICE_BYTES + kk * 16 * T::W_ROW_BYTES,
              T::W_SLICE_BYTES, 8 * T::W_ROW_BYTES, T::LAYOUT);
          wgmma<T::WN>(acc[T::COMBINED ? (k4 < SW ? k4 : 0) : 0]
                       [T::COMBINED ? 0 : k4],
                    ad[k4], desc, kk > 0 || u > 0);
        }
        wgmma_commit();
#pragma unroll
        for (int i = 0; i < SW; ++i)
#pragma unroll
          for (int p = 0; p < T::PHASE_ACCS; ++p) fence_regs(acc[i][p]);
        wgmma_wait<NBUF - 1>();
      }
    }
    wgmma_wait<0>();
#pragma unroll
    for (int i = 0; i < SW; ++i)
#pragma unroll
      for (int p = 0; p < T::PHASE_ACCS; ++p) fence_regs(acc[i][p]);
    // the span: output rows 2*r0 .. 2*(r0 + rows) - 1 of image b
    const int64_t span = (int64_t)2 * rows * 2 * W * Cout;  // elements
    __nv_bfloat16* dst = out + ((int64_t)b * 2 * H + 2 * r0) * 2 * W * Cout;
    if constexpr (T::COMBINED) {
      // A product's zero columns (the phases that do not use its shift)
      // times a non-finite input give NaN in sums that do not hold that
      // input. Where any sum is NaN, the block computes the span again,
      // each output from its own phase's four taps (plain f32 sums over
      // the band and the weight in shared memory), and stores it
      // directly: a NaN there is one in the plain version too.
      bool redo = false;
#pragma unroll
      for (int i = 0; i < SW; ++i)
#pragma unroll
        for (int r = 0; r < T::WN / 2; ++r) redo |= isnan(acc[i][0][r]);
      // and every ldmatrix of the band is done
      if (__syncthreads_or(redo)) {
        for (int e = tid; e < span; e += THREADS) {
          const int n = e % Cout, ox = (e / Cout) % (2 * W);
          const int oy = e / (Cout * 2 * W);
          const int t = oy >> 1, py = oy & 1, s = ox >> 1, px = ox & 1;
          const int col = NP * (2 * py + px) + n;  // phase q's channel n
          float sum = 0.f;
          for (int j0 = 0; j0 < 2; ++j0)
            for (int j1 = 0; j1 < 2; ++j1) {
              const int pix = (t + py + j0) * W2 + s + px + j1;
              const unsigned char* wd =
                  smem + ((py + j0) * 3 + px + j1) * T::W_SLICE_BYTES;
              for (int ci = 0; ci < CIN; ++ci) {
                const int sw =
                    ((ci * T::W_ROW_BYTES) >> 7) & (T::W_ROW_CHUNKS - 1);
                const float xv = __bfloat162float(
                    *reinterpret_cast<const __nv_bfloat16*>(
                        band + band_off<CIN>(pix, ci >> 3) + (ci & 7) * 2));
                const float wv = __bfloat162float(
                    *reinterpret_cast<const __nv_bfloat16*>(
                        wd + ci * T::W_ROW_BYTES +
                        (((col >> 3) ^ sw) << 4) + (col & 7) * 2));
                sum = fmaf(xv, wv, sum);
              }
            }
          dst[e] = __float2bfloat16(
              epilogue(sum, s_scale[n], s_shift[n], neg));
        }
        __syncthreads();  // the band is read before this buffer is reloaded
        continue;
      }
    } else {
      __syncthreads();  // every ldmatrix of the band is done
    }
    // the band's space is reused from here

    // epilogue into shared memory in output order: output row 2t + py,
    // column 2s + px of the band's span (2 rows x 2W pixels x Cout).
    // Register 4j + 2h + e of acc[i][p] is slab row (warp % 4) * 16 + g +
    // 8h, column 8j + c2 + e: COMBINED, phase (8j + c2) / NP and channel
    // c2 % NP + e; else phase p and channel 8j + c2 + e.
    const uint32_t stage = sBand;
#pragma unroll
    for (int i = 0; i < SW; ++i) {
      const int sl = wg + 2 * i;
      if (sl >= slabs) continue;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = sl * 64 + (warp & 3) * 16 + g + 8 * h;
        if (m >= M) continue;
        const int t = m / W, s = m - t * W;
        const uint32_t o = stage + ((2 * t) * 2 * W + 2 * s) * Cout * 2;
#pragma unroll
        for (int p = 0; p < T::PHASE_ACCS; ++p)
#pragma unroll
          for (int j = 0; j < T::WN / 8; ++j) {
            const int q = T::COMBINED ? (8 * j + c2) / NP : p;
            const int n = T::COMBINED ? c2 % NP : 8 * j + c2;  // and n + 1
            const int k = T::COMBINED ? 0 : 2 * j;  // its sc, sh
            const float v0 = epilogue(acc[i][p][4 * j + 2 * h], sc[k], sh[k],
                                      neg);
            const float v1 = epilogue(acc[i][p][4 * j + 2 * h + 1],
                                      sc[k + 1], sh[k + 1], neg);
            // phase q's pixel (py, px) of the output pixel pair
            const uint32_t at =
                o + (((q >> 1) * 2 * W + (q & 1)) * Cout + n) * 2;
            if (pairs) {
              if (n < Cout) st_shared_b32(at, pack_bf16(v0, v1));
            } else {
              if (n < Cout) st_shared_b16(at, v0);
              if (n + 1 < Cout) st_shared_b16(at + 2, v1);
            }
          }
      }
    }
    __nv_bfloat16* stage_ptr = reinterpret_cast<__nv_bfloat16*>(band);
    __syncthreads();

    if ((reinterpret_cast<uintptr_t>(dst) & 15) == 0 && span % 8 == 0) {
      for (int64_t v = tid; v < span / 8; v += THREADS)
        reinterpret_cast<uint4*>(dst)[v] =
            reinterpret_cast<const uint4*>(stage_ptr)[v];
    } else {
      for (int64_t v = tid; v < span; v += THREADS) dst[v] = stage_ptr[v];
    }
    __syncthreads();  // the span is read before this buffer is reloaded
  }
  cp_async_wait<0>();
}

template <int CIN, int NP>
int smem_bytes(int W, int R) {
  return Band<CIN, NP>::W_BYTES + 2 * (R + 2) * (W + 2) * CIN * 2 + 1024;
}

template <int CIN, int NP>
cudaError_t launch(const void* x, const void* wp, const float* scale,
                   const float* shift, void* out, int B, int H, int W,
                   int Cout, int act, int R, cudaStream_t stream) {
  auto kernel = convt4x4s2_band_kernel<CIN, NP>;
  const int smem = smem_bytes<CIN, NP>(W, R);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  // one block a multiprocessor (its registers take more than half of one)
  int dev = 0, sms = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(
           &sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return err;
  const int items = B * ((H + R - 1) / R);
  const int grid = items < sms ? items : sms;
  kernel<<<grid, THREADS, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(x),
      static_cast<const __nv_bfloat16*>(wp), scale, shift,
      static_cast<__nv_bfloat16*>(out), B, H, W, Cout, act, R);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point, called by the op's host code in convt_op.cpp, which
// has checked the arguments (bf16, Cin in {32, 64}, 1 <= Cout <= 32, x
// 16-byte aligned, 1 <= rows, the band's rows * W pixels within the
// kernel's slabs, its output span within the band's space, and its shared
// memory within the card's). Launches on ``stream``; it neither
// synchronises nor allocates. Returns the status of the launch (or of the
// calls before it), which the caller turns into an error.
extern "C" int xgan_convt4x4s2_band_launch(
    const void* x, const void* wp, const float* scale, const float* shift,
    void* out, int B, int H, int W, int Cin, int Cout, int act, int rows,
    cudaStream_t stream) {
#define XGAN_BAND(CIN, NP)                                                \
  launch<CIN, NP>(x, wp, scale, shift, out, B, H, W, Cout, act, rows, \
                  stream)
  if (Cin == 32)
    return Cout <= 4 ? XGAN_BAND(32, 4)
                     : Cout <= 8 ? XGAN_BAND(32, 8) : XGAN_BAND(32, 32);
  if (Cin == 64)
    return Cout <= 4 ? XGAN_BAND(64, 4)
                     : Cout <= 8 ? XGAN_BAND(64, 8) : XGAN_BAND(64, 32);
#undef XGAN_BAND
  return cudaErrorInvalidValue;
}
