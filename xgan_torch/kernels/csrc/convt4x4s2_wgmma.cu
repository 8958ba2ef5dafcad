// Fused ConvTranspose2d(k=4, s=2, p=1) + per-channel affine + activation,
// NHWC, bf16, on Hopper's warpgroup tensor-core instruction (wgmma,
// sm_90a): the wide layers.
//
// Replaces the Pallas TPU kernel xgan/ops/pallas/convt.py:convt4x4s2_fused
// (body _kernel, pallas_call at convt.py:101) on the bf16 route for
// Cin % 32 == 0, Cout % 8 == 0 and Cout >= 32 where the route rule sends
// it (xgan_torch/kernels/convt.py:convt_route): layers 1-3 of the DCGAN
// and 1-4 of the WGAN-GP G-224 ladders. The rule sends Cout 32 where a
// band fits (DCGAN layer 4, 64 -> 32), which this kernel also takes, to
// convt4x4s2_band.cu, measured faster there; other bf16 shapes stay on
// the mma.sync kernel of convt4x4s2_mma.cu. It computes the same function: output pixel
// (2t+py, 2s+px) is the sum over j0, j1 in {0, 1} of
// x[b, t-1+py+j0, s-1+px+j1, :] @ wp[py,px,j0,j1] (zero outside the image)
// in f32, then act(acc * scale + shift) in f32, rounded once to bf16.
//
// What bounds it (G-224, batch 64, H100 SXM at 989 TFLOP/s and 3.35
// TB/s): DCGAN layers 1-3 and WGAN-GP layers 1-4 are bound by operations
// (13.15 and 52.6 GFLOP a layer: 13.3 and 53.2 us); DCGAN layer 4 (64 ->
// 32 at 56) by bytes (77 MB, 23 us). mma.sync reaches 187-226 TFLOP/s on
// those layers; wgmma is the only instruction that reaches the card's
// tensor-core rate. Measured (PERF.md §6): the products alone run at
// about half the card's rate at block_n 256; what holds the kernel above
// that is its loads, A (the gathered pixels, read again from L2 for each
// phase and tap) most at small block_n, and the load of a chunk not fully
// hidden behind the products of the one before.
//
// Design: the implicit GEMM of convt4x4s2_mma.cu, one per output phase
// (py, px): M = B*H*W pixels of the phase, N = Cout, K = 4*Cin with the
// taps (j0, j1) outermost, so K index k = tap*Cin + ci walks the packed
// weight's rows wp[py][px] in order. Grid (ceil(M/128), ceil(Cout/BN), 4
// phases); a block of two warpgroups (256 threads) computes a 128 x BN
// tile, each warpgroup one m64 slab, BN in {32, 64, 128, 256} from the
// route. K is walked in chunks of BK = 64 (128-byte rows).
// - A (the gathered, zero-filled input pixels of a tap): 16-byte cp.async
//   of 8 channels each, src-size 0 (zero fill) for a pixel outside the
//   image or a row past M. A 16-byte column of a chunk lies in one tap
//   (Cin % 8 == 0), so Cin = 32 (two taps a chunk) needs no special case.
//   Rows padded to 144 B, so ldmatrix.x4 reads without bank conflicts.
//   A reaches wgmma in registers: ldmatrix.x4 gives the m16n8k16 A layout
//   that register-A wgmma takes, and a gathered tile needs no fitting to
//   a descriptor's canonical layout.
// - B (the 64 x BN slice of wp, N contiguous): 16-byte cp.async into the
//   MN-major canonical layout with the 128-byte swizzle (64-byte for BN =
//   32) applied at the store; read by wgmma through a descriptor with
//   imm-trans-b = 1. Columns >= Cout are zero filled.
// - A ring of STAGES slots (5 at BN = 128 and 32, else 4; BN = 64 and 32
//   keep two blocks on a multiprocessor) in dynamic shared memory.
//   Each K-chunk: wait for its cp.async group, fence.proxy.async (the
//   copies were made by the generic proxy, wgmma reads through the async
//   proxy), __syncthreads, prefetch chunk kt + STAGES - 2 into the slot
//   of chunk kt - 2, ldmatrix the chunk's A into one of two register
//   sets, wgmma.fence, four m64nBNk16 products, commit, then
//   wgmma.wait_group 1: the products of chunk kt - 1 have retired (their
//   A registers and ring slot are free again) while those of chunk kt
//   run on.
// - Epilogue: scale/shift/act in f32 on the accumulator fragment, one
//   bf16 rounding, bf16x2 stores to out[b, 2t+py, 2s+px, n] (Cout is even).
//   Each output element belongs to one phase and one tile: written once.
//
// Left for later (ROADMAP B1): TMA loads with mbarrier pipelines, warp
// specialisation (a producer warp) and persistent blocks, clusters with
// multicast of the weight slice; a backward.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "tensor_core.cuh"

namespace {

using namespace xgan_tc;

constexpr int BM = 128, BK = 64, THREADS = 256;
constexpr int A_LD = BK + 8;  // bf16 per A row in shared memory (144 B)
constexpr int A_STAGE_BYTES = BM * A_LD * 2;
constexpr int A_COPIES = BM * BK / 8 / THREADS;  // 16-byte A copies a thread

template <int BN>
struct Wide {
  // ring slots: BN = 64 and 32 keep two blocks on a multiprocessor
  static constexpr int STAGES = BN == 128 || BN == 32 ? 5 : 4;
  static constexpr int ATOM_N = BN >= 64 ? 64 : 32;  // columns an atom
  static constexpr int ROW_BYTES = ATOM_N * 2;       // one K row of an atom
  static constexpr int ROW_CHUNKS = ROW_BYTES / 16;
  static constexpr int ATOM_BYTES = BK * ROW_BYTES;
  static constexpr uint64_t LAYOUT = BN >= 64 ? 1 : 2;
  static constexpr int B_STAGE_BYTES = BK * BN * 2;
  static constexpr int B_COPIES = BK * BN / 8 / THREADS;
  static constexpr int SMEM_BYTES =
      STAGES * (B_STAGE_BYTES + A_STAGE_BYTES) + 1024;  // + alignment slack
  static_assert(B_COPIES >= 1, "BN too small for one copy a thread");
};

template <int BN>
__global__ void __launch_bounds__(THREADS, 1)
convt4x4s2_wgmma_kernel(const __nv_bfloat16* __restrict__ x,
                        const __nv_bfloat16* __restrict__ wp,
                        const float* __restrict__ scale,
                        const float* __restrict__ shift,
                        __nv_bfloat16* __restrict__ out, int B, int H, int W,
                        int Cin, int Cout, int act) {
  using T = Wide<BN>;
  extern __shared__ unsigned char smem_raw[];
  // B tiles first, 1,024-byte aligned (the swizzle acts on address bits)
  const uint32_t raw = smem_addr(smem_raw);
  unsigned char* smem = smem_raw + ((1024 - (raw & 1023)) & 1023);
  const uint32_t sB = smem_addr(smem);
  unsigned char* sA_ptr = smem + T::STAGES * T::B_STAGE_BYTES;
  const uint32_t sA = smem_addr(sA_ptr);

  const int HW = H * W, M = B * HW;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const int phase = blockIdx.z, py = phase >> 1, px = phase & 1;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int KT = 4 * Cin / BK;  // even: Cin % 32 == 0

  // This thread's A copies: 16-byte column a_col of tile rows a_row + 32*i;
  // a_pix: the input pixel of tap (0,0) of that row; a_taps bit
  // 4*i + tap: tap (j0, j1) = (tap / 2, tap % 2) lies inside the image
  // (never set for a row past M).
  const int a_row = tid >> 3, a_col = (tid & 7) * 8;
  int a_pix[A_COPIES];
  unsigned a_taps = 0;
#pragma unroll
  for (int i = 0; i < A_COPIES; ++i) {
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
  const __nv_bfloat16* w_phase = wp + (int64_t)phase * 4 * Cin * Cout;

  auto load_chunk = [&](int kt, int slot) {
    // A: K index kt*64 + a_col lies in tap k / Cin, channel k % Cin
    const int k = kt * BK + a_col;
    const int tap = k / Cin, ci = k - tap * Cin;
    const int dpix = (tap >> 1) * W + (tap & 1);
    const uint32_t sa = sA + slot * A_STAGE_BYTES;
#pragma unroll
    for (int i = 0; i < A_COPIES; ++i) {
      const bool ok = (a_taps >> (4 * i + tap)) & 1u;
      const __nv_bfloat16* src =
          ok ? x + (int64_t)(a_pix[i] + dpix) * Cin + ci : x;
      cp_async16(sa + ((a_row + 32 * i) * A_LD + a_col) * 2, src, ok);
    }
    // B: rows kt*64 .. +63 of wp[py][px] (K x Cout), BN columns from n0
    const uint32_t sb = sB + slot * T::B_STAGE_BYTES;
#pragma unroll
    for (int i = 0; i < T::B_COPIES; ++i) {
      const int c = tid + THREADS * i;
      const int r = c / (BN / 8), chunk = c % (BN / 8);
      const int n = n0 + chunk * 8;
      const bool ok = n < Cout;
      const int atom = chunk / T::ROW_CHUNKS, cc = chunk % T::ROW_CHUNKS;
      const int sw = ((r * T::ROW_BYTES) >> 7) & (T::ROW_CHUNKS - 1);
      cp_async16(sb + atom * T::ATOM_BYTES + r * T::ROW_BYTES +
                     ((cc ^ sw) << 4),
                 ok ? w_phase + (int64_t)(kt * BK + r) * Cout + n : wp, ok);
    }
  };

  float acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;

#pragma unroll
  for (int s = 0; s < T::STAGES - 2; ++s) {
    if (s < KT) load_chunk(s, s);
    cp_async_commit();
  }

  // ldmatrix row addresses: lanes 8q..8q+7 give the rows of matrix q
  const int wrow = (warp >> 2) * 64 + (warp & 3) * 16;  // warp's 16 rows
  const int ld_r = (lane & 7) + ((lane >> 3) & 1) * 8;  // 0..15
  const int ld_hi = lane >> 4;                          // 0 or 1
  const uint32_t a_lane = ((wrow + ld_r) * A_LD + ld_hi * 8) * 2;

  auto step = [&](int kt, uint32_t (&a)[BK / 16][4]) {
    cp_async_wait<T::STAGES - 3>();  // this thread's copies of chunk kt
    fence_proxy_async();
    // every thread's copies of chunk kt are visible; every warpgroup's
    // products of chunk kt - 2 have retired, so its slot can be refilled
    __syncthreads();
    if (kt + T::STAGES - 2 < KT)
      load_chunk(kt + T::STAGES - 2, (kt + T::STAGES - 2) % T::STAGES);
    cp_async_commit();
    const int slot = kt % T::STAGES;
#pragma unroll
    for (int j = 0; j < BK / 16; ++j)
      ldsm_x4(sA + slot * A_STAGE_BYTES + a_lane + j * 32, a[j]);
    const uint32_t sb = sB + slot * T::B_STAGE_BYTES;
    fence_regs(acc);
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < BK / 16; ++j)
      wgmma<BN>(acc, a[j],
                smem_desc(sb + j * 16 * T::ROW_BYTES, T::ATOM_BYTES,
                          8 * T::ROW_BYTES, T::LAYOUT));
    wgmma_commit();
    fence_regs(acc);
    wgmma_wait<1>();
  };

  // two A register sets, so that chunk kt's ldmatrix never writes the
  // registers that chunk kt - 1's products may still be reading
  uint32_t a0[BK / 16][4], a1[BK / 16][4];
  for (int kt = 0; kt < KT; kt += 2) {
    step(kt, a0);
    step(kt + 1, a1);
  }
  wgmma_wait<0>();
  fence_regs(acc);

  // Epilogue: element 4j + 2h + e of acc is tile row wrow + g + 8h,
  // column 8j + c2 + e.
  const int g = lane >> 2, c2 = (lane & 3) * 2;
  const float neg = act_slope(act);
  int o_pix[2];  // output element offset of each row, -1 past M
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = m0 + wrow + g + 8 * h;
    const int b = row / HW, r = row - b * HW, t = r / W, s = r - t * W;
    o_pix[h] = row < M
                   ? ((b * 2 * H + 2 * t + py) * 2 * W + 2 * s + px) * Cout
                   : -1;
  }
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const int col = n0 + 8 * j + c2;
    if (col >= Cout) continue;  // Cout % 8 == 0: col + 1 < Cout too
    const float sc0 = scale[col], sh0 = shift[col];
    const float sc1 = scale[col + 1], sh1 = shift[col + 1];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if (o_pix[h] < 0) continue;
      const float v0 = epilogue(acc[4 * j + 2 * h], sc0, sh0, neg);
      const float v1 = epilogue(acc[4 * j + 2 * h + 1], sc1, sh1, neg);
      *reinterpret_cast<__nv_bfloat162*>(out + o_pix[h] + col) =
          __floats2bfloat162_rn(v0, v1);
    }
  }
}

template <int BN>
cudaError_t launch(const void* x, const void* wp, const float* scale,
                   const float* shift, void* out, int B, int H, int W,
                   int Cin, int Cout, int act, cudaStream_t stream) {
  constexpr int smem = Wide<BN>::SMEM_BYTES;
  // set on every launch: the attribute belongs to the current device
  cudaError_t err = cudaFuncSetAttribute(
      convt4x4s2_wgmma_kernel<BN>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const int M = B * H * W;
  const dim3 grid((M + BM - 1) / BM, (Cout + BN - 1) / BN, 4);
  convt4x4s2_wgmma_kernel<BN><<<grid, THREADS, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(x),
      static_cast<const __nv_bfloat16*>(wp), scale, shift,
      static_cast<__nv_bfloat16*>(out), B, H, W, Cin, Cout, act);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point, called by the op's host code in convt_op.cpp, which
// has checked the arguments (bf16, Cin % 32 == 0, Cout % 8 == 0 and
// Cout >= 32, 16-byte aligned pointers, block_n in {32, 64, 128, 256}).
// Launches on ``stream``; it neither synchronises nor allocates. Returns
// the status of the launch (or of the shared-memory attribute call before
// it), which the caller turns into an error.
extern "C" int xgan_convt4x4s2_wgmma_launch(
    const void* x, const void* wp, const float* scale, const float* shift,
    void* out, int B, int H, int W, int Cin, int Cout, int act, int block_n,
    cudaStream_t stream) {
  switch (block_n) {
    case 32:
      return launch<32>(x, wp, scale, shift, out, B, H, W, Cin, Cout, act,
                        stream);
    case 64:
      return launch<64>(x, wp, scale, shift, out, B, H, W, Cin, Cout, act,
                        stream);
    case 128:
      return launch<128>(x, wp, scale, shift, out, B, H, W, Cin, Cout, act,
                         stream);
    case 256:
      return launch<256>(x, wp, scale, shift, out, B, H, W, Cin, Cout, act,
                         stream);
    default:
      return cudaErrorInvalidValue;
  }
}
