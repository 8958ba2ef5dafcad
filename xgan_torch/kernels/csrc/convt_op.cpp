// Host code of the ConvT ops under torch.ops.xgan_torch:
// - convt4x4s2_fused: the CUDA-core kernel of convt4x4s2.cu (f32 or bf16,
//   any Cin);
// - convt4x4s2_mma: the mma.sync tensor-core kernel of convt4x4s2_mma.cu
//   (bf16, Cin % 32 == 0);
// - convt4x4s2_wgmma: the warpgroup tensor-core kernel of
//   convt4x4s2_wgmma.cu (bf16, Cin % 32 == 0, Cout % 8 == 0, Cout >= 32);
// - convt4x4s2_band: the four-phase band kernel of convt4x4s2_band.cu
//   (bf16, Cin 32 or 64, Cout <= 32).
// Each checks its arguments, allocates the output and launches its kernel
// on PyTorch's current stream, then checks the launch. None falls back to
// another: xgan_torch/kernels/convt.py picks the op before the launch.
//
// This file holds no device code, so the host compiler builds it while
// nvcc builds the kernels (xgan_torch/kernels/build.py); only the light
// torch headers below are included to keep that compile short.

#include <ATen/core/Tensor.h>
#include <ATen/ops/empty.h>
#include <c10/cuda/CUDAException.h>
#include <c10/cuda/CUDAGuard.h>
#include <c10/cuda/CUDAStream.h>
#include <cuda_runtime_api.h>
#include <torch/library.h>

#include <cstdint>

extern "C" void xgan_convt4x4s2_launch(
    const void* x, const void* wp, const float* scale, const float* shift,
    void* out, int B, int H, int W, int Cin, int Cout, int act, int dtype,
    cudaStream_t stream);
extern "C" int xgan_convt4x4s2_mma_launch(
    const void* x, const void* wp, const float* scale, const float* shift,
    void* out, int B, int H, int W, int Cin, int Cout, int act, int block_n,
    cudaStream_t stream);
extern "C" int xgan_convt4x4s2_wgmma_launch(
    const void* x, const void* wp, const float* scale, const float* shift,
    void* out, int B, int H, int W, int Cin, int Cout, int act, int block_n,
    cudaStream_t stream);
extern "C" int xgan_convt4x4s2_band_launch(
    const void* x, const void* wp, const float* scale, const float* shift,
    void* out, int B, int H, int W, int Cin, int Cout, int act, int rows,
    cudaStream_t stream);

namespace {

struct Dims {
  int64_t B, H, W, Cin, Cout;
};

// The checks both ops share; ``op`` names the op in the messages.
Dims check_args(const char* op, const at::Tensor& x, const at::Tensor& wp,
                const at::Tensor& scale, const at::Tensor& shift,
                int64_t act) {
  TORCH_CHECK(x.is_cuda() && wp.is_cuda() && scale.is_cuda() &&
                  shift.is_cuda(),
              op, ": all tensors must be CUDA tensors");
  TORCH_CHECK(wp.device() == x.device() && scale.device() == x.device() &&
                  shift.device() == x.device(),
              op, ": all tensors must be on one device");
  TORCH_CHECK(x.scalar_type() == at::kFloat ||
                  x.scalar_type() == at::kBFloat16,
              op, ": x must be float32 or bfloat16, got ", x.scalar_type());
  TORCH_CHECK(wp.scalar_type() == x.scalar_type(), op,
              ": packed weight dtype ", wp.scalar_type(),
              " differs from x dtype ", x.scalar_type());
  TORCH_CHECK(x.dim() == 4 && x.is_contiguous(), op,
              ": x must be a contiguous (B,H,W,Cin) tensor");
  const int64_t B = x.size(0), H = x.size(1), W = x.size(2), Cin = x.size(3);
  TORCH_CHECK(wp.dim() == 6 && wp.size(0) == 2 && wp.size(1) == 2 &&
                  wp.size(2) == 2 && wp.size(3) == 2 && wp.is_contiguous(),
              op, ": packed weight must be a contiguous (2,2,2,2,Cin,Cout) "
              "tensor");
  TORCH_CHECK(wp.size(4) == Cin, op, ": x has Cin=", Cin,
              " but the weight has Cin=", wp.size(4));
  const int64_t Cout = wp.size(5);
  TORCH_CHECK(scale.scalar_type() == at::kFloat &&
                  shift.scalar_type() == at::kFloat &&
                  scale.is_contiguous() && shift.is_contiguous() &&
                  scale.numel() == Cout && shift.numel() == Cout,
              op, ": scale/shift must be contiguous float32 (Cout,) tensors");
  TORCH_CHECK(act >= 0 && act <= 2, op,
              ": act must be 0 (none), 1 (relu) or 2 (leaky_relu), got ",
              act);
  TORCH_CHECK(B * 4 * H * W * Cout < (int64_t)1 << 31 &&
                  B * H * W * Cin < (int64_t)1 << 31,
              op, ": tensor too large for int32 extents");
  return {B, H, W, Cin, Cout};
}

at::Tensor convt4x4s2_fused(const at::Tensor& x, const at::Tensor& wp,
                            const at::Tensor& scale, const at::Tensor& shift,
                            int64_t act) {
  const Dims d = check_args("convt4x4s2_fused", x, wp, scale, shift, act);
  c10::cuda::CUDAGuard guard(x.device());
  at::Tensor out = at::empty({d.B, 2 * d.H, 2 * d.W, d.Cout}, x.options());
  if (out.numel() == 0) return out;
  xgan_convt4x4s2_launch(
      x.data_ptr(), wp.data_ptr(), scale.data_ptr<float>(),
      shift.data_ptr<float>(), out.data_ptr(), (int)d.B, (int)d.H, (int)d.W,
      (int)d.Cin, (int)d.Cout, (int)act,
      x.scalar_type() == at::kBFloat16 ? 1 : 0,
      c10::cuda::getCurrentCUDAStream(x.get_device()).stream());
  C10_CUDA_KERNEL_LAUNCH_CHECK();
  return out;
}

bool aligned16(const at::Tensor& t) {
  return reinterpret_cast<uintptr_t>(t.data_ptr()) % 16 == 0;
}

// block_n: the tile width that xgan_torch/kernels/convt.py:mma_tiles
// picked for Cout.
at::Tensor convt4x4s2_mma(const at::Tensor& x, const at::Tensor& wp,
                          const at::Tensor& scale, const at::Tensor& shift,
                          int64_t act, int64_t block_n) {
  const Dims d = check_args("convt4x4s2_mma", x, wp, scale, shift, act);
  TORCH_CHECK(x.scalar_type() == at::kBFloat16,
              "convt4x4s2_mma: x must be bfloat16, got ", x.scalar_type());
  TORCH_CHECK(d.Cin > 0 && d.Cin % 32 == 0,
              "convt4x4s2_mma: Cin must be a positive multiple of 32, got ",
              d.Cin);
  TORCH_CHECK(block_n == 8 || block_n == 32 || block_n == 64 ||
                  block_n == 128,
              "convt4x4s2_mma: block_n must be 8, 32, 64 or 128, got ",
              block_n);
  TORCH_CHECK(aligned16(x) && aligned16(wp),
              "convt4x4s2_mma: x and the packed weight must start on a "
              "16-byte boundary");
  c10::cuda::CUDAGuard guard(x.device());
  at::Tensor out = at::empty({d.B, 2 * d.H, 2 * d.W, d.Cout}, x.options());
  if (out.numel() == 0) return out;
  TORCH_CHECK(aligned16(out),
              "convt4x4s2_mma: the output must start on a 16-byte boundary");
  const int err = xgan_convt4x4s2_mma_launch(
      x.data_ptr(), wp.data_ptr(), scale.data_ptr<float>(),
      shift.data_ptr<float>(), out.data_ptr(), (int)d.B, (int)d.H, (int)d.W,
      (int)d.Cin, (int)d.Cout, (int)act, (int)block_n,
      c10::cuda::getCurrentCUDAStream(x.get_device()).stream());
  TORCH_CHECK(err == cudaSuccess, "convt4x4s2_mma: launch failed: ",
              cudaGetErrorString(static_cast<cudaError_t>(err)));
  return out;
}

// block_n: the tile width that xgan_torch/kernels/convt.py:convt_route
// picked for the shape.
at::Tensor convt4x4s2_wgmma(const at::Tensor& x, const at::Tensor& wp,
                            const at::Tensor& scale, const at::Tensor& shift,
                            int64_t act, int64_t block_n) {
  const Dims d = check_args("convt4x4s2_wgmma", x, wp, scale, shift, act);
  TORCH_CHECK(x.scalar_type() == at::kBFloat16,
              "convt4x4s2_wgmma: x must be bfloat16, got ", x.scalar_type());
  TORCH_CHECK(d.Cin > 0 && d.Cin % 32 == 0,
              "convt4x4s2_wgmma: Cin must be a positive multiple of 32, got ",
              d.Cin);
  TORCH_CHECK(d.Cout >= 32 && d.Cout % 8 == 0,
              "convt4x4s2_wgmma: Cout must be a multiple of 8 and at least "
              "32, got ", d.Cout);
  TORCH_CHECK(block_n == 32 || block_n == 64 || block_n == 128 ||
                  block_n == 256,
              "convt4x4s2_wgmma: block_n must be 32, 64, 128 or 256, got ",
              block_n);
  TORCH_CHECK(aligned16(x) && aligned16(wp),
              "convt4x4s2_wgmma: x and the packed weight must start on a "
              "16-byte boundary");
  c10::cuda::CUDAGuard guard(x.device());
  at::Tensor out = at::empty({d.B, 2 * d.H, 2 * d.W, d.Cout}, x.options());
  if (out.numel() == 0) return out;
  TORCH_CHECK(aligned16(out),
              "convt4x4s2_wgmma: the output must start on a 16-byte "
              "boundary");
  const int err = xgan_convt4x4s2_wgmma_launch(
      x.data_ptr(), wp.data_ptr(), scale.data_ptr<float>(),
      shift.data_ptr<float>(), out.data_ptr(), (int)d.B, (int)d.H, (int)d.W,
      (int)d.Cin, (int)d.Cout, (int)act, (int)block_n,
      c10::cuda::getCurrentCUDAStream(x.get_device()).stream());
  TORCH_CHECK(err == cudaSuccess, "convt4x4s2_wgmma: launch failed: ",
              cudaGetErrorString(static_cast<cudaError_t>(err)));
  return out;
}

// Shared memory of the band kernel's block (convt4x4s2_band.cu: the
// weight's 9 (Cout <= 8) or 16 slices of Cin rows of 16 (Cout <= 4) or 32
// columns, two bands of rows + 2 padded input rows, 1 KB of alignment
// slack); an output span reuses its band's space.
int64_t band_smem_bytes(int64_t W, int64_t Cin, int64_t Cout, int64_t rows) {
  const int64_t slices = Cout <= 8 ? 9 : 16, cols = Cout <= 4 ? 16 : 32;
  return slices * Cin * cols * 2 + 2 * (rows + 2) * (W + 2) * Cin * 2 + 1024;
}

// rows: the input rows of a band, from xgan_torch/kernels/convt.py:
// convt_route.
at::Tensor convt4x4s2_band(const at::Tensor& x, const at::Tensor& wp,
                           const at::Tensor& scale, const at::Tensor& shift,
                           int64_t act, int64_t rows) {
  const Dims d = check_args("convt4x4s2_band", x, wp, scale, shift, act);
  TORCH_CHECK(x.scalar_type() == at::kBFloat16,
              "convt4x4s2_band: x must be bfloat16, got ", x.scalar_type());
  TORCH_CHECK(d.Cin == 32 || d.Cin == 64,
              "convt4x4s2_band: Cin must be 32 or 64, got ", d.Cin);
  TORCH_CHECK(d.Cout >= 1 && d.Cout <= 32,
              "convt4x4s2_band: Cout must be 1 to 32, got ", d.Cout);
  const int64_t slabs = d.Cout <= 8 ? 8 : 2;  // the kernel's 2 * SW
  TORCH_CHECK(rows >= 1 && rows * d.W <= 64 * slabs,
              "convt4x4s2_band: rows must be at least 1 with rows * W <= ",
              64 * slabs, ", got rows ", rows, " at W ", d.W);
  TORCH_CHECK(band_smem_bytes(d.W, d.Cin, d.Cout, rows) <= 232448 &&
                  4 * rows * d.W * d.Cout <= (rows + 2) * (d.W + 2) * d.Cin,
              "convt4x4s2_band: a band of ", rows, " rows at W ", d.W,
              " does not fit in shared memory");
  TORCH_CHECK(aligned16(x), "convt4x4s2_band: x must start on a 16-byte "
              "boundary");
  c10::cuda::CUDAGuard guard(x.device());
  at::Tensor out = at::empty({d.B, 2 * d.H, 2 * d.W, d.Cout}, x.options());
  if (out.numel() == 0) return out;
  const int err = xgan_convt4x4s2_band_launch(
      x.data_ptr(), wp.data_ptr(), scale.data_ptr<float>(),
      shift.data_ptr<float>(), out.data_ptr(), (int)d.B, (int)d.H, (int)d.W,
      (int)d.Cin, (int)d.Cout, (int)act, (int)rows,
      c10::cuda::getCurrentCUDAStream(x.get_device()).stream());
  TORCH_CHECK(err == cudaSuccess, "convt4x4s2_band: launch failed: ",
              cudaGetErrorString(static_cast<cudaError_t>(err)));
  return out;
}

}  // namespace

TORCH_LIBRARY(xgan_torch, m) {
  m.def(
      "convt4x4s2_fused(Tensor x, Tensor wp, Tensor scale, Tensor shift, "
      "int act) -> Tensor");
  m.def(
      "convt4x4s2_mma(Tensor x, Tensor wp, Tensor scale, Tensor shift, "
      "int act, int block_n) -> Tensor");
  m.def(
      "convt4x4s2_wgmma(Tensor x, Tensor wp, Tensor scale, Tensor shift, "
      "int act, int block_n) -> Tensor");
  m.def(
      "convt4x4s2_band(Tensor x, Tensor wp, Tensor scale, Tensor shift, "
      "int act, int rows) -> Tensor");
}

TORCH_LIBRARY_IMPL(xgan_torch, CUDA, m) {
  m.impl("convt4x4s2_fused", &convt4x4s2_fused);
  m.impl("convt4x4s2_mma", &convt4x4s2_mma);
  m.impl("convt4x4s2_wgmma", &convt4x4s2_wgmma);
  m.impl("convt4x4s2_band", &convt4x4s2_band);
}
