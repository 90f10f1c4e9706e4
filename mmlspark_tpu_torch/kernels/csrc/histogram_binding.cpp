// Python binding of the Hopper histogram kernels: histogram.cu (node-keyed
// histogram), u_histogram.cu (U pass) and bin_scatter.cu (packed-space
// histogram from the bins).
//
// Only pybind11 is included here, not PyTorch's headers: the wrappers in
// mmlspark_tpu_torch/ops/ (hopper_histogram.py, u_histogram.py) check
// devices, types, shapes and contiguity, allocate the outputs, and pass raw
// device pointers and the current CUDA stream as integers. That keeps the
// build to seconds.

#include <cstdint>
#include <stdexcept>
#include <string>

#include <pybind11/pybind11.h>

extern "C" int mmlspark_hist_launch(const std::uint8_t* bins_t, const float* grad,
                                    const float* hess, const float* count,
                                    const std::int32_t* node, const double* scale,
                                    long long n, int f, int k, int b, int fg, int row_blocks,
                                    long long rows_per_block, int threads, int smem_bytes,
                                    unsigned long long* acc, float* out, void* stream);
extern "C" const char* mmlspark_hist_error_string(int code);
extern "C" int mmlspark_u_panel_dot_launch(const std::uint8_t* u, const void* stats,
                                           const std::int32_t* node, const double* scale,
                                           int quant, long long n, long long n_pad, int k_pad,
                                           int k, int chunk_rows, int grid_x, int grid_y,
                                           long long rows_per_block, int threads,
                                           int smem_bytes, void* out, void* stream);
extern "C" int mmlspark_bin_scatter_launch(const std::uint8_t* bins, const void* stats,
                                           const std::int32_t* node, const double* scale,
                                           const std::int32_t* layout, int quant, long long n,
                                           long long chunk, int f, int k_rows, int k,
                                           int chunk_rows, int grid_x, int grid_y,
                                           long long rows_per_block, int threads,
                                           int smem_bytes, void* out, void* stream);

namespace {

void check(int err, const char* what)
{
    if (err != 0) {
        throw std::runtime_error(std::string(what) + " kernel launch failed: " +
                                 mmlspark_hist_error_string(err));
    }
}

void histogram(std::uintptr_t bins_t, std::uintptr_t grad, std::uintptr_t hess,
               std::uintptr_t count, std::uintptr_t node, std::uintptr_t scale, long long n,
               int f, int k, int b, int fg, int row_blocks, long long rows_per_block, int threads,
               int smem_bytes, std::uintptr_t acc, std::uintptr_t out, std::uintptr_t stream)
{
    const int err = mmlspark_hist_launch(
        reinterpret_cast<const std::uint8_t*>(bins_t), reinterpret_cast<const float*>(grad),
        reinterpret_cast<const float*>(hess), reinterpret_cast<const float*>(count),
        reinterpret_cast<const std::int32_t*>(node), reinterpret_cast<const double*>(scale), n,
        f, k, b, fg, row_blocks, rows_per_block, threads, smem_bytes,
        reinterpret_cast<unsigned long long*>(acc), reinterpret_cast<float*>(out),
        reinterpret_cast<void*>(stream));
    check(err, "histogram");
}

void u_panel_dot(std::uintptr_t u, std::uintptr_t stats, std::uintptr_t node,
                 std::uintptr_t scale, int quant, long long n, long long n_pad, int k_pad, int k,
                 int chunk_rows, int grid_x, int grid_y, long long rows_per_block, int threads,
                 int smem_bytes, std::uintptr_t out, std::uintptr_t stream)
{
    check(mmlspark_u_panel_dot_launch(
              reinterpret_cast<const std::uint8_t*>(u), reinterpret_cast<const void*>(stats),
              reinterpret_cast<const std::int32_t*>(node), reinterpret_cast<const double*>(scale),
              quant, n, n_pad, k_pad, k, chunk_rows, grid_x, grid_y, rows_per_block, threads,
              smem_bytes, reinterpret_cast<void*>(out), reinterpret_cast<void*>(stream)),
          "U panel dot");
}

void bin_scatter(std::uintptr_t bins, std::uintptr_t stats, std::uintptr_t node,
                 std::uintptr_t scale, std::uintptr_t layout, int quant, long long n,
                 long long chunk, int f, int k_rows, int k, int chunk_rows, int grid_x,
                 int grid_y, long long rows_per_block, int threads, int smem_bytes,
                 std::uintptr_t out, std::uintptr_t stream)
{
    check(mmlspark_bin_scatter_launch(
              reinterpret_cast<const std::uint8_t*>(bins), reinterpret_cast<const void*>(stats),
              reinterpret_cast<const std::int32_t*>(node), reinterpret_cast<const double*>(scale),
              reinterpret_cast<const std::int32_t*>(layout), quant, n, chunk, f, k_rows, k,
              chunk_rows, grid_x, grid_y, rows_per_block, threads, smem_bytes,
              reinterpret_cast<void*>(out), reinterpret_cast<void*>(stream)),
          "bin scatter");
}

}  // namespace

PYBIND11_MODULE(TORCH_EXTENSION_NAME, m)
{
    m.def("histogram", &histogram,
          "Launch the node-keyed histogram kernel on the given CUDA stream.");
    m.def("u_panel_dot", &u_panel_dot,
          "Launch the U-pass contraction kernel on the given CUDA stream.");
    m.def("bin_scatter", &bin_scatter,
          "Launch the packed-space bin-scatter kernel on the given CUDA stream.");
}
