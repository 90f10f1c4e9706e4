// Python binding of the Hopper histogram kernel (histogram.cu).
//
// Only pybind11 is included here, not PyTorch's headers: the wrapper in
// mmlspark_tpu_torch/ops/hopper_histogram.py checks devices, types, shapes
// and contiguity, allocates the output, and passes raw device pointers and
// the current CUDA stream as integers. That keeps the build to seconds.

#include <cstdint>
#include <stdexcept>
#include <string>

#include <pybind11/pybind11.h>

extern "C" int mmlspark_hist_launch(const std::uint8_t* bins_t, const float* grad,
                                    const float* hess, const float* count,
                                    const std::int32_t* node, const double* scale,
                                    long long n, int f, int k, int b, int fg, int grid_x,
                                    long long rows_per_block, int threads, int smem_bytes,
                                    unsigned long long* acc, float* out, void* stream);
extern "C" const char* mmlspark_hist_error_string(int code);

namespace {

void histogram(std::uintptr_t bins_t, std::uintptr_t grad, std::uintptr_t hess,
               std::uintptr_t count, std::uintptr_t node, std::uintptr_t scale, long long n,
               int f, int k, int b, int fg, int grid_x, long long rows_per_block, int threads,
               int smem_bytes, std::uintptr_t acc, std::uintptr_t out, std::uintptr_t stream)
{
    const int err = mmlspark_hist_launch(
        reinterpret_cast<const std::uint8_t*>(bins_t), reinterpret_cast<const float*>(grad),
        reinterpret_cast<const float*>(hess), reinterpret_cast<const float*>(count),
        reinterpret_cast<const std::int32_t*>(node), reinterpret_cast<const double*>(scale), n,
        f, k, b, fg, grid_x, rows_per_block, threads, smem_bytes,
        reinterpret_cast<unsigned long long*>(acc), reinterpret_cast<float*>(out),
        reinterpret_cast<void*>(stream));
    if (err != 0) {
        throw std::runtime_error(std::string("histogram kernel launch failed: ") +
                                 mmlspark_hist_error_string(err));
    }
}

}  // namespace

PYBIND11_MODULE(TORCH_EXTENSION_NAME, m)
{
    m.def("histogram", &histogram,
          "Launch the node-keyed histogram kernel on the given CUDA stream.");
}
