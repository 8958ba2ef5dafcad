// Mixed-source row gather for Hopper (sm_90a):
//   out[i] = use_synth[i] ? synth[synth_idx[i]] : real[real_idx[i]]
// over uint8 image stores (N, S, S, 3) viewed as rows of S*S*3 bytes. The
// B rows may be the k * B rows of k folds' batches (--parallel-folds): one
// launch then gathers every fold's batch, as the vmapped Pallas call does
// under xgan's fold vmap (xgan/train/parallel_folds.py:125-135).
//
// Replaces the Pallas TPU kernel xgan/ops/pallas/gather.py:mixed_gather
// (body _mixed_gather_kernel, pallas_call at gather.py:109). Like it, each
// output row is copied from the one source its mask bit selects; the
// other store is never read. The TPU kernel's (rows, 128) view and its
// d % 128 assert are a TPU tiling rule and are dropped here: any row size
// works.
//
// Bound: a pure copy, so bytes. It must read B rows and write B rows,
// 2*B*S*S*3 bytes plus the indices and mask; at B = 32, 224 px that is
// 9.63 MB, ~2.9 us at 3.35 TB/s. A launch costs about as much, so at the
// classifier's batch this kernel is bound by launch latency, not by HBM.
//
// Design: the grid is (chunks, B). Each block copies one CHUNK-byte piece
// of one output row with 16-byte uint4 loads and stores (neighbouring
// threads on neighbouring addresses) and a byte loop for a tail; a piece
// whose source or destination is not 16-byte aligned (rows of S*S*3 bytes
// are a multiple of 16 only when S % 4 == 0) is copied byte by byte. One
// block per row would leave 100 of the 132 SMs idle at B = 32; 16 KB
// pieces give 320 blocks there. Each block reads its own mask bit and
// both indices. An index out of range (either one, so that the kernel and
// the plain version reject the same inputs) skips the copy and sets *err
// to 1; the host reads that flag when it chooses, so a step needs no
// sync. TMA bulk copies, and fusing the flip and normalize, are later
// work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int64_t kChunk = 16384;  // bytes of one row per block

__global__ void __launch_bounds__(kThreads)
mixed_gather_kernel(const uint8_t* __restrict__ real,
                    const uint8_t* __restrict__ synth,
                    const int64_t* __restrict__ real_idx,
                    const int64_t* __restrict__ synth_idx,
                    const bool* __restrict__ use_synth,
                    uint8_t* __restrict__ out, int64_t n_real,
                    int64_t n_synth, int64_t row_bytes, int* err) {
  const int64_t row = blockIdx.y;
  const int64_t ri = real_idx[row], si = synth_idx[row];
  if (ri < 0 || ri >= n_real || si < 0 || si >= n_synth) {
    if (threadIdx.x == 0) *err = 1;  // every writer stores the same 1
    return;
  }
  const int64_t begin = (int64_t)blockIdx.x * kChunk;
  if (begin >= row_bytes) return;
  const int64_t len =
      row_bytes - begin < kChunk ? row_bytes - begin : kChunk;
  const uint8_t* src =
      (use_synth[row] ? synth + si * row_bytes : real + ri * row_bytes) +
      begin;
  uint8_t* dst = out + row * row_bytes + begin;

  int64_t done = 0;
  if ((((uintptr_t)src | (uintptr_t)dst) & 15) == 0) {
    const int64_t nvec = len >> 4;
    const uint4* s4 = reinterpret_cast<const uint4*>(src);
    uint4* d4 = reinterpret_cast<uint4*>(dst);
    for (int64_t v = threadIdx.x; v < nvec; v += kThreads) d4[v] = s4[v];
    done = nvec << 4;
  }
  for (int64_t b = done + threadIdx.x; b < len; b += kThreads)
    dst[b] = src[b];
}

}  // namespace

// Plain C entry point, called by the op's host code in gather_op.cpp.
// Launches on ``stream``; it neither synchronises, allocates nor clears
// the launch status, which the caller reads right after
// (C10_CUDA_KERNEL_LAUNCH_CHECK).
extern "C" void xgan_mixed_gather_launch(
    const uint8_t* real, const uint8_t* synth, const int64_t* real_idx,
    const int64_t* synth_idx, const bool* use_synth, uint8_t* out,
    int64_t n_real, int64_t n_synth, int B, int64_t row_bytes, int* err,
    cudaStream_t stream) {
  const dim3 grid((unsigned)((row_bytes + kChunk - 1) / kChunk),
                  (unsigned)B);
  mixed_gather_kernel<<<grid, kThreads, 0, stream>>>(
      real, synth, real_idx, synth_idx, use_synth, out, n_real, n_synth,
      row_bytes, err);
}
