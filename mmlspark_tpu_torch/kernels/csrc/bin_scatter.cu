// Packed-space histogram straight from the raw bins, for Hopper (sm_90a).
//
// Replaces the TPU kernel `_bin_scatter_kernel` in
// mmlspark_tpu/ops/pallas_histogram.py, reached there through
// `build_histograms_bin_scatter`: the same (K_pad, 3k) result as the U pass
// (u_histogram.cu), fed by the feature-major uint8 bins instead of U:
//
//   acc[off_f + bins[f, i], s*k + node_i] += stat_s[i]
//
// for rows whose key lies in [0, k) and bins inside their feature's width.
// Sums are exact integers (packed_hist.cuh), so the result equals the plain
// version (bin_scatter_plain) and the U pass on the same rows bit for bit.
//
// What bounds it: a pass needs only F bytes of bins, the stats and the key
// of each row. The TPU kernel rebuilt each tile's one-hot in VMEM and
// contracted it on the MXU; here, as in histogram.cu, the histogram is
// privatized in shared memory instead:
//
// - grid (packed-row chunks, row blocks); a block owns `chunk_rows` packed
//   rows, whose (chunk_rows, 3k) accumulator fills its shared memory (many
//   features at few nodes, a part of one feature at 42), and a contiguous
//   row range. The chunk index varies fastest, so the blocks that read one
//   row range run together and find its stats in L2;
// - each thread walks rows with a block-wide stride (coalesced loads of the
//   key, the stats and each feature's bins), turns the stats into integers
//   once per row and adds them into the cells of every feature of the chunk
//   whose packed row falls inside it, with shared-memory atomics;
// - the block flushes its nonzero cells into the zeroed global accumulator
//   with atomics.

#include <cstdint>

#include <cuda_runtime.h>

#include "packed_hist.cuh"

namespace {

using mmlspark_packed::Acc;
using mmlspark_packed::atomic_add;
using mmlspark_packed::stat_value;

template <bool kQuant>
__global__ void __launch_bounds__(1024)
bin_scatter_kernel(const std::uint8_t* __restrict__ bins_t,  // (f, n) feature-major
                   const void* __restrict__ stats,            // (3, n) int8 | bf16 bits
                   const std::int32_t* __restrict__ node,     // (n,)
                   const double* __restrict__ scale,          // (3,), bf16 stats only
                   const std::int32_t* __restrict__ layout,   // offsets (f), widths (f),
                                                              // (first, last) feature per chunk
                   long long n, int f, int k_pad, int k, int chunk_rows,
                   long long rows_per_block,
                   typename Acc<kQuant>::T* __restrict__ out)  // (k_pad, 3k), zeroed
{
    using T = typename Acc<kQuant>::T;
    extern __shared__ __align__(16) unsigned char smem_raw[];
    T* acc = reinterpret_cast<T*>(smem_raw);  // (chunk_rows, 3k)
    const int width = 3 * k;
    const int c0 = blockIdx.x * chunk_rows;
    const int nc = min(chunk_rows, k_pad - c0);
    const std::int32_t* offsets = layout;
    const std::int32_t* widths = layout + f;
    const int f_first = layout[2 * f + 2 * blockIdx.x];
    const int f_last = layout[2 * f + 2 * blockIdx.x + 1];

    for (int j = threadIdx.x; j < nc * width; j += blockDim.x) {
        acc[j] = T(0);
    }
    double s0 = 0.0, s1 = 0.0, s2 = 0.0;
    if constexpr (!kQuant) {
        s0 = scale[0];
        s1 = scale[1];
        s2 = scale[2];
    }
    __syncthreads();

    const long long r0 = static_cast<long long>(blockIdx.y) * rows_per_block;
    const long long r1 = min(n, r0 + rows_per_block);
    for (long long i = r0 + threadIdx.x; i < r1; i += blockDim.x) {
        const int key = node[i];
        if (key < 0 || key >= k) {
            continue;
        }
        const T q0 = stat_value<kQuant>(stats, i, s0);
        const T q1 = stat_value<kQuant>(stats, n + i, s1);
        const T q2 = stat_value<kQuant>(stats, 2 * n + i, s2);
        for (int ff = f_first; ff <= f_last; ++ff) {
            const int bin = bins_t[static_cast<long long>(ff) * n + i];
            if (bin >= __ldg(widths + ff)) {
                continue;
            }
            const int c = __ldg(offsets + ff) + bin - c0;
            if (c < 0 || c >= nc) {
                continue;
            }
            T* cell = acc + c * width + key;
            atomic_add(cell, q0);
            atomic_add(cell + k, q1);
            atomic_add(cell + 2 * k, q2);
        }
    }
    __syncthreads();
    mmlspark_packed::flush(acc, nc * width, out + static_cast<long long>(c0) * width);
}

template <bool kQuant>
int launch(const std::uint8_t* bins_t, const void* stats, const std::int32_t* node,
           const double* scale, const std::int32_t* layout, long long n, int f, int k_pad,
           int k, int chunk_rows, int grid_x, int grid_y, long long rows_per_block, int threads,
           int smem_bytes, void* out, cudaStream_t stream)
{
    cudaError_t err = cudaFuncSetAttribute(
        bin_scatter_kernel<kQuant>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
    if (err != cudaSuccess) {
        return static_cast<int>(err);
    }
    bin_scatter_kernel<kQuant><<<dim3(grid_x, grid_y), threads, smem_bytes, stream>>>(
        bins_t, stats, node, scale, layout, n, f, k_pad, k, chunk_rows, rows_per_block,
        static_cast<typename Acc<kQuant>::T*>(out));
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int mmlspark_bin_scatter_launch(const std::uint8_t* bins_t, const void* stats,
                                           const std::int32_t* node, const double* scale,
                                           const std::int32_t* layout, int quant, long long n,
                                           int f, int k_pad, int k, int chunk_rows, int grid_x,
                                           int grid_y, long long rows_per_block, int threads,
                                           int smem_bytes, void* out, void* stream)
{
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (quant) {
        return launch<true>(bins_t, stats, node, scale, layout, n, f, k_pad, k, chunk_rows,
                            grid_x, grid_y, rows_per_block, threads, smem_bytes, out, s);
    }
    return launch<false>(bins_t, stats, node, scale, layout, n, f, k_pad, k, chunk_rows, grid_x,
                         grid_y, rows_per_block, threads, smem_bytes, out, s);
}
