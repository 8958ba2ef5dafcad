// Host op torch.ops.xgan_torch.png_unfilter(raw, h, stride, bpp): undoes
// the PNG row filters of one (sub-)image, the byte loop of a PNG decode.
//
// Counterpart of what libpng does for the JAX package's store
// (xgan/native/png_writer.cpp:74-219); the rest of the decode (inflate,
// Adam7 passes, bit depths, colour conversion) stays in
// xgan_torch/native/png.py, whose numpy/Python _unfilter is the plain
// version of this op.
//
// raw: contiguous uint8 CPU tensor of h rows of 1 + stride bytes, each a
// filter-type byte (0 None, 1 Sub, 2 Up, 3 Average, 4 Paeth) and the
// filtered bytes; bpp: bytes per complete pixel, 1 to 8 (1 below 8 bits
// per pixel), the distance to the "left" byte. Returns the (h, stride)
// unfiltered bytes. An unknown filter type or a bad argument raises
// ValueError. The Python binding of torch ops releases the GIL while the
// op runs, so the store's threads decode in parallel.
//
// Host code only: no device code and no CUDA headers. nvcc drives its
// compile like the op bindings' (xgan_torch/kernels/build.py).

#include <ATen/core/Tensor.h>
#include <ATen/ops/empty.h>
#include <torch/library.h>

#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <vector>

namespace {

inline int paeth(int a, int b, int c) {
  const int p = a + b - c;
  const int pa = std::abs(p - a), pb = std::abs(p - b), pc = std::abs(p - c);
  if (pa <= pb && pa <= pc) return a;
  return pb <= pc ? b : c;
}

at::Tensor png_unfilter(const at::Tensor& raw, int64_t h, int64_t stride,
                        int64_t bpp) {
  TORCH_CHECK_VALUE(raw.device().is_cpu() && raw.is_contiguous() &&
                        raw.scalar_type() == at::kByte,
                    "png_unfilter: raw must be a contiguous uint8 CPU "
                    "tensor");
  TORCH_CHECK_VALUE(bpp >= 1 && bpp <= 8,
                    "png_unfilter: bpp must be 1 to 8, got ", bpp);
  TORCH_CHECK_VALUE(h >= 0 && stride >= 0 && raw.numel() == h * (1 + stride),
                    "png_unfilter: raw has ", raw.numel(), " bytes, not h * "
                    "(1 + stride) = ", h, " * ", 1 + stride);
  at::Tensor out = at::empty({h, stride}, raw.options());
  const uint8_t* in = raw.data_ptr<uint8_t>();
  uint8_t* dst = out.data_ptr<uint8_t>();
  const std::vector<uint8_t> zeros(stride, 0);
  const uint8_t* up = zeros.data();  // the row above the first is zero
  const int64_t b = bpp < stride ? bpp : stride;
  for (int64_t y = 0; y < h; ++y) {
    const uint8_t kind = in[y * (1 + stride)];
    const uint8_t* line = in + y * (1 + stride) + 1;
    uint8_t* cur = dst + y * stride;
    switch (kind) {
      case 0:
        std::memcpy(cur, line, stride);
        break;
      case 1:
        std::memcpy(cur, line, b);
        for (int64_t i = b; i < stride; ++i)
          cur[i] = static_cast<uint8_t>(line[i] + cur[i - bpp]);
        break;
      case 2:
        for (int64_t i = 0; i < stride; ++i)
          cur[i] = static_cast<uint8_t>(line[i] + up[i]);
        break;
      case 3:
        for (int64_t i = 0; i < b; ++i)
          cur[i] = static_cast<uint8_t>(line[i] + (up[i] >> 1));
        for (int64_t i = b; i < stride; ++i)
          cur[i] = static_cast<uint8_t>(
              line[i] + ((cur[i - bpp] + up[i]) >> 1));
        break;
      case 4:
        // left and upper-left are 0 for the first pixel: Paeth(0, up, 0)
        // is up
        for (int64_t i = 0; i < b; ++i)
          cur[i] = static_cast<uint8_t>(line[i] + up[i]);
        for (int64_t i = b; i < stride; ++i)
          cur[i] = static_cast<uint8_t>(
              line[i] + paeth(cur[i - bpp], up[i], up[i - bpp]));
        break;
      default:
        TORCH_CHECK_VALUE(false, "unknown PNG row filter ", int(kind),
                          " in row ", y);
    }
    up = cur;
  }
  return out;
}

}  // namespace

TORCH_LIBRARY_FRAGMENT(xgan_torch, m) {
  m.def("png_unfilter(Tensor raw, int h, int stride, int bpp) -> Tensor");
}

TORCH_LIBRARY_IMPL(xgan_torch, CPU, m) {
  m.impl("png_unfilter", &png_unfilter);
}
