// Host code of the op torch.ops.xgan_torch.convt4x4s2_fused: checks the
// arguments, allocates the output and launches the kernel of
// convt4x4s2.cu on PyTorch's current stream.
//
// This file holds no device code, so the host compiler builds it while
// nvcc builds the kernel (xgan_torch/kernels/build.py); only the light
// torch headers below are included to keep that compile short.

#include <ATen/core/Tensor.h>
#include <ATen/ops/empty.h>
#include <c10/cuda/CUDAException.h>
#include <c10/cuda/CUDAGuard.h>
#include <c10/cuda/CUDAStream.h>
#include <cuda_runtime_api.h>
#include <torch/library.h>

extern "C" void xgan_convt4x4s2_launch(
    const void* x, const void* wp, const float* scale, const float* shift,
    void* out, int B, int H, int W, int Cin, int Cout, int act, int dtype,
    cudaStream_t stream);

namespace {

at::Tensor convt4x4s2_fused(const at::Tensor& x, const at::Tensor& wp,
                            const at::Tensor& scale, const at::Tensor& shift,
                            int64_t act) {
  TORCH_CHECK(x.is_cuda() && wp.is_cuda() && scale.is_cuda() &&
                  shift.is_cuda(),
              "convt4x4s2_fused: all tensors must be CUDA tensors");
  TORCH_CHECK(wp.device() == x.device() && scale.device() == x.device() &&
                  shift.device() == x.device(),
              "convt4x4s2_fused: all tensors must be on one device");
  TORCH_CHECK(x.scalar_type() == at::kFloat ||
                  x.scalar_type() == at::kBFloat16,
              "convt4x4s2_fused: x must be float32 or bfloat16, got ",
              x.scalar_type());
  TORCH_CHECK(wp.scalar_type() == x.scalar_type(),
              "convt4x4s2_fused: packed weight dtype ", wp.scalar_type(),
              " differs from x dtype ", x.scalar_type());
  TORCH_CHECK(x.dim() == 4 && x.is_contiguous(),
              "convt4x4s2_fused: x must be a contiguous (B,H,W,Cin) tensor");
  const int64_t B = x.size(0), H = x.size(1), W = x.size(2), Cin = x.size(3);
  TORCH_CHECK(wp.dim() == 6 && wp.size(0) == 2 && wp.size(1) == 2 &&
                  wp.size(2) == 2 && wp.size(3) == 2 && wp.is_contiguous(),
              "convt4x4s2_fused: packed weight must be a contiguous "
              "(2,2,2,2,Cin,Cout) tensor");
  TORCH_CHECK(wp.size(4) == Cin, "convt4x4s2_fused: x has Cin=", Cin,
              " but the weight has Cin=", wp.size(4));
  const int64_t Cout = wp.size(5);
  TORCH_CHECK(scale.scalar_type() == at::kFloat &&
                  shift.scalar_type() == at::kFloat &&
                  scale.is_contiguous() && shift.is_contiguous() &&
                  scale.numel() == Cout && shift.numel() == Cout,
              "convt4x4s2_fused: scale/shift must be contiguous float32 "
              "(Cout,) tensors");
  TORCH_CHECK(act >= 0 && act <= 2,
              "convt4x4s2_fused: act must be 0 (none), 1 (relu) or 2 "
              "(leaky_relu), got ", act);
  TORCH_CHECK(B * 4 * H * W * Cout < (int64_t)1 << 31 &&
                  B * H * W * Cin < (int64_t)1 << 31,
              "convt4x4s2_fused: tensor too large for int32 extents");

  c10::cuda::CUDAGuard guard(x.device());
  at::Tensor out = at::empty({B, 2 * H, 2 * W, Cout}, x.options());
  if (out.numel() == 0) return out;
  xgan_convt4x4s2_launch(
      x.data_ptr(), wp.data_ptr(), scale.data_ptr<float>(),
      shift.data_ptr<float>(), out.data_ptr(), (int)B, (int)H, (int)W,
      (int)Cin, (int)Cout, (int)act,
      x.scalar_type() == at::kBFloat16 ? 1 : 0,
      c10::cuda::getCurrentCUDAStream(x.get_device()).stream());
  C10_CUDA_KERNEL_LAUNCH_CHECK();
  return out;
}

}  // namespace

TORCH_LIBRARY(xgan_torch, m) {
  m.def(
      "convt4x4s2_fused(Tensor x, Tensor wp, Tensor scale, Tensor shift, "
      "int act) -> Tensor");
}

TORCH_LIBRARY_IMPL(xgan_torch, CUDA, m) {
  m.impl("convt4x4s2_fused", &convt4x4s2_fused);
}
