// Host code of the op torch.ops.xgan_torch.mixed_gather: checks the
// arguments, allocates the output and launches the kernel of
// mixed_gather.cu on PyTorch's current stream. Out-of-range indices are
// reported through ``err``, a one-element int32 device flag that the
// caller owns and reads when it chooses (xgan_torch/kernels/gather.py).
//
// This file holds no device code, so the host compiler builds it while
// nvcc builds the kernel (xgan_torch/kernels/build.py).

#include <ATen/core/Tensor.h>
#include <ATen/ops/empty.h>
#include <c10/cuda/CUDAException.h>
#include <c10/cuda/CUDAGuard.h>
#include <c10/cuda/CUDAStream.h>
#include <cuda_runtime_api.h>
#include <torch/library.h>

#include <vector>

extern "C" void xgan_mixed_gather_launch(
    const uint8_t* real, const uint8_t* synth, const int64_t* real_idx,
    const int64_t* synth_idx, const bool* use_synth, uint8_t* out,
    int64_t n_real, int64_t n_synth, int B, int64_t row_bytes, int* err,
    cudaStream_t stream);

namespace {

at::Tensor mixed_gather(const at::Tensor& real, const at::Tensor& synth,
                        const at::Tensor& real_idx,
                        const at::Tensor& synth_idx,
                        const at::Tensor& use_synth, at::Tensor& err) {
  const at::Tensor* all[] = {&real,      &synth,     &real_idx,
                             &synth_idx, &use_synth, &err};
  for (const at::Tensor* t : all) {
    TORCH_CHECK(t->is_cuda() && t->device() == real.device(),
                "mixed_gather: all tensors must be CUDA tensors on one "
                "device");
    TORCH_CHECK(t->is_contiguous(),
                "mixed_gather: all tensors must be contiguous");
  }
  TORCH_CHECK(real.scalar_type() == at::kByte &&
                  synth.scalar_type() == at::kByte,
              "mixed_gather: the stores must be uint8, got ",
              real.scalar_type(), " and ", synth.scalar_type());
  TORCH_CHECK(real.dim() == 4 && synth.dim() == 4,
              "mixed_gather: the stores must be (N, S, S, C) tensors");
  TORCH_CHECK(real.sizes().slice(1).equals(synth.sizes().slice(1)),
              "mixed_gather: real rows ", real.sizes().slice(1),
              " differ from synthetic rows ", synth.sizes().slice(1));
  TORCH_CHECK(real_idx.scalar_type() == at::kLong &&
                  synth_idx.scalar_type() == at::kLong,
              "mixed_gather: indices must be int64, got ",
              real_idx.scalar_type(), " and ", synth_idx.scalar_type());
  TORCH_CHECK(use_synth.scalar_type() == at::kBool,
              "mixed_gather: use_synth must be bool, got ",
              use_synth.scalar_type());
  TORCH_CHECK(real_idx.dim() == 1 && synth_idx.dim() == 1 &&
                  use_synth.dim() == 1,
              "mixed_gather: indices and mask must be (B,) tensors");
  const int64_t B = real_idx.size(0);
  TORCH_CHECK(synth_idx.size(0) == B && use_synth.size(0) == B,
              "mixed_gather: real_idx has ", B, " rows, synth_idx ",
              synth_idx.size(0), ", use_synth ", use_synth.size(0));
  TORCH_CHECK(B <= 65535, "mixed_gather: at most 65535 rows, got ", B);
  TORCH_CHECK(err.scalar_type() == at::kInt && err.numel() == 1,
              "mixed_gather: err must be a one-element int32 tensor");

  c10::cuda::CUDAGuard guard(real.device());
  std::vector<int64_t> shape(real.sizes().begin(), real.sizes().end());
  shape[0] = B;
  at::Tensor out = at::empty(shape, real.options());
  const int64_t row_bytes = real.size(1) * real.size(2) * real.size(3);
  if (out.numel() == 0) return out;
  xgan_mixed_gather_launch(
      real.data_ptr<uint8_t>(), synth.data_ptr<uint8_t>(),
      real_idx.data_ptr<int64_t>(), synth_idx.data_ptr<int64_t>(),
      use_synth.data_ptr<bool>(), out.data_ptr<uint8_t>(), real.size(0),
      synth.size(0), (int)B, row_bytes, err.data_ptr<int>(),
      c10::cuda::getCurrentCUDAStream(real.get_device()).stream());
  C10_CUDA_KERNEL_LAUNCH_CHECK();
  return out;
}

}  // namespace

TORCH_LIBRARY_FRAGMENT(xgan_torch, m) {
  m.def(
      "mixed_gather(Tensor real, Tensor synth, Tensor real_idx, "
      "Tensor synth_idx, Tensor use_synth, Tensor(a!) err) -> Tensor");
}

TORCH_LIBRARY_IMPL(xgan_torch, CUDA, m) {
  m.impl("mixed_gather", &mixed_gather);
}
