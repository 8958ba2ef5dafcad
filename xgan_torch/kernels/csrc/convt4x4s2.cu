// Fused ConvTranspose2d(k=4, s=2, p=1) + per-channel affine + activation,
// NHWC, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel xgan/ops/pallas/convt.py:convt4x4s2_fused
// (body _kernel, pallas_call at convt.py:101). It computes the same
// function: output pixel (2t+py, 2s+px) is the sum over j0, j1 in {0, 1}
// of x[t-1+py+j0, s-1+px+j1, :] @ W[:, :, 3-py-2*j0, 3-px-2*j1] (torch
// layout W (Cin, Cout, 4, 4); zero outside the image), accumulated in f32,
// then y = act(acc * scale[co] + shift[co]) written once in x's dtype. With
// eval BN folded into scale/shift this is a whole ConvT+BN+ReLU layer of
// the DCGAN generator.
//
// Weights arrive repacked phase-major, wp[py][px][j0][j1][Cin][Cout]
// (xgan_torch/kernels/convt.py:pack_convt_weight, once at load time), so
// the 4x4 taps that feed one output phase are four contiguous (Cin, Cout)
// matrices.
//
// Design (first, simple version): one thread per output element, Cout
// innermost across threads, so the weight reads of a warp coalesce and
// each x value is a broadcast within a pixel's threads. Every output is
// written exactly once, so the phase interleave costs no extra pass.
// What bounds it on this card: the G-224 layers 1-3 are operation-bound
// (2*Cin*4 FLOP per output, 13.2 GFLOP per layer at batch 64) and layers
// 4 and 5 byte-bound. This version runs on the CUDA cores with two
// loads per FMA, far from the tensor-core roofline. It serves f32 and
// shapes with Cin % 32 != 0; bf16 with Cin % 32 == 0, the bf16 sampler's
// every layer, runs on the tensor-core kernel of convt4x4s2_mma.cu
// (route chosen in xgan_torch/kernels/convt.py).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);  // round to nearest even
}

// act: 0 = none, 1 = relu, 2 = leaky_relu(0.2)
template <typename T>
__global__ void __launch_bounds__(256)
convt4x4s2_kernel(const T* __restrict__ x, const T* __restrict__ wp,
                  const float* __restrict__ scale,
                  const float* __restrict__ shift, T* __restrict__ out,
                  int B, int H, int W, int Cin, int Cout, int act) {
  const int OH = 2 * H, OW = 2 * W;
  const int64_t total = (int64_t)B * OH * OW * Cout;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t idx = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
       idx < total; idx += stride) {
    const int co = (int)(idx % Cout);
    int64_t r = idx / Cout;
    const int ox = (int)(r % OW);
    r /= OW;
    const int oy = (int)(r % OH);
    const int b = (int)(r / OH);
    const int py = oy & 1, t = oy >> 1;
    const int px = ox & 1, s = ox >> 1;

    float acc = 0.f;
#pragma unroll
    for (int j0 = 0; j0 < 2; ++j0) {
      const int iy = t - 1 + py + j0;
      if (iy < 0 || iy >= H) continue;
#pragma unroll
      for (int j1 = 0; j1 < 2; ++j1) {
        const int ix = s - 1 + px + j1;
        if (ix < 0 || ix >= W) continue;
        const T* xr = x + (((int64_t)b * H + iy) * W + ix) * Cin;
        const int tap = ((py * 2 + px) * 2 + j0) * 2 + j1;
        const T* wr = wp + (int64_t)tap * Cin * Cout + co;
#pragma unroll 4
        for (int ci = 0; ci < Cin; ++ci)
          acc = fmaf(to_f32(xr[ci]), to_f32(wr[(int64_t)ci * Cout]), acc);
      }
    }
    float v = fmaf(acc, scale[co], shift[co]);
    if (act == 1) {
      v = fmaxf(v, 0.f);
    } else if (act == 2) {
      v = v >= 0.f ? v : 0.2f * v;
    }
    out[idx] = from_f32<T>(v);
  }
}

template <typename T>
void launch(const void* x, const void* wp, const float* scale,
            const float* shift, void* out, int B, int H, int W, int Cin,
            int Cout, int act, cudaStream_t stream) {
  const int64_t total = (int64_t)B * 4 * H * W * Cout;
  const int threads = 256;
  int64_t blocks = (total + threads - 1) / threads;
  if (blocks > 2147483647LL) blocks = 2147483647LL;
  convt4x4s2_kernel<T><<<(unsigned)blocks, threads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(wp), scale, shift,
      static_cast<T*>(out), B, H, W, Cin, Cout, act);
}

}  // namespace

// Plain C entry point, called by the op's host code in convt_op.cpp.
// dtype: 0 = float32, 1 = bfloat16. Launches on ``stream``; it neither
// synchronises, allocates nor clears the launch status, which the caller
// reads right after (C10_CUDA_KERNEL_LAUNCH_CHECK).
extern "C" void xgan_convt4x4s2_launch(
    const void* x, const void* wp, const float* scale, const float* shift,
    void* out, int B, int H, int W, int Cin, int Cout, int act, int dtype,
    cudaStream_t stream) {
  if (dtype == 1)
    launch<__nv_bfloat16>(x, wp, scale, shift, out, B, H, W, Cin, Cout, act,
                          stream);
  else
    launch<float>(x, wp, scale, shift, out, B, H, W, Cin, Cout, act, stream);
}
