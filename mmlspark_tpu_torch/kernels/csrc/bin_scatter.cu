// Packed-space histogram straight from the raw bins, for Hopper (sm_90a).
//
// Replaces the TPU kernel `_bin_scatter_kernel` in
// mmlspark_tpu/ops/pallas_histogram.py, reached there through
// `build_histograms_bin_scatter`: the same (K_pad, 3k) result as the U pass
// (u_histogram.cu), fed by the uint8 bins instead of U:
//
//   acc[off_f + bins[f, i], s*k + node_i] += stat_s[i]
//
// for rows whose key lies in [0, k) and bins inside their feature's width.
// Sums are exact integers (packed_hist.cuh), so the result equals the plain
// version (bin_scatter_plain) and the U pass on the same rows bit for bit.
//
// The bins come as a stack of row chunks, (m, F, chunk) uint8: row i is
// column i % chunk of chunk i / chunk, the layout of the chunked U pass
// (prepare_chunked_bins), which takes this kernel in one launch per pass
// over all chunks. The plain feature-major (F, N) bins are the stack with
// m = 1. The stats (3, N) and keys (N,) are read in place; rows of the
// stack at or past N (its padded tail) are not walked.
//
// What bounds it: a pass needs only F bytes of bins, the stats and the key
// of each row, about 0.12 ms at 11M x 28 on an H100 at 3.35 TB/s. The TPU
// kernel rebuilt each tile's one-hot in VMEM and contracted it on the MXU;
// here, as in histogram.cu, the histogram is privatized in shared memory,
// and the shared atomics (3 a keyed row and feature on int8 stats, up to 6
// on bf16 ones) bound it:
//
// - grid (packed-row chunks, row blocks); a block owns `chunk_rows` packed
//   rows, whose (chunk_rows, 3k) cells fill its shared memory (many
//   features at few nodes, a part of one or two features at 42), and a
//   contiguous row range. The chunk index varies fastest, so the blocks that
//   read one row range run together and all but the first find its keys and
//   stats in L2;
// - vector row walk: each thread takes 4 consecutive rows a step, their keys
//   with one 16-byte load, each stat with one 4-byte (int8) or 8-byte (bf16)
//   load and each feature's bins with one 32-bit load, and turns the stats
//   into integers once per row for all the features of its chunk. A load
//   whose address is off its vector boundary (N % 4 != 0, a view at an
//   offset), the last partial step of a range and a step that crosses from
//   one chunk of the stack into the next take scalar loads instead;
// - the cells are added with 32-bit shared atomics (int32 cells, or int64
//   cells as two planes of uint32 halves with a carry, packed_hist.cuh), and
//   the block flushes its nonzero cells into the zeroed global accumulator
//   with global atomics.

#include <cstdint>

#include <cuda_runtime.h>

#include "packed_hist.cuh"

namespace {

using mmlspark_packed::SharedAcc;

// Rows a thread takes per step of its walk.
constexpr int kRows = 4;

__device__ __forceinline__ bool aligned(const void* p, unsigned bytes)
{
    return (reinterpret_cast<std::uintptr_t>(p) & (bytes - 1)) == 0;
}

// The 4 rows' values of one stat (row `s` of the (3, n) stats) as the
// integers the kernel sums.
template <bool kQuant>
__device__ __forceinline__ void load_stat(const void* stats, long long at, bool full,
                                          long long left, double scale,
                                          typename SharedAcc<kQuant>::Value (&q)[kRows])
{
    if constexpr (kQuant) {
        const std::int8_t* p = static_cast<const std::int8_t*>(stats) + at;
        if (full && aligned(p, 4)) {
            const unsigned w = __ldg(reinterpret_cast<const unsigned*>(p));
#pragma unroll
            for (int r = 0; r < kRows; ++r) {
                q[r] = static_cast<int>(static_cast<std::int8_t>(w >> (8 * r)));
            }
        } else {
#pragma unroll
            for (int r = 0; r < kRows; ++r) {
                q[r] = r < left ? mmlspark_packed::quant_value(__ldg(p + r)) : 0;
            }
        }
    } else {
        const std::uint16_t* p = static_cast<const std::uint16_t*>(stats) + at;
        if (full && aligned(p, 8)) {
            const uint2 w = __ldg(reinterpret_cast<const uint2*>(p));
            const unsigned words[2] = {w.x, w.y};
#pragma unroll
            for (int r = 0; r < kRows; ++r) {
                q[r] = mmlspark_packed::fixed_value(
                    static_cast<std::uint16_t>(words[r >> 1] >> (16 * (r & 1))), scale);
            }
        } else {
#pragma unroll
            for (int r = 0; r < kRows; ++r) {
                q[r] = r < left ? mmlspark_packed::fixed_value(__ldg(p + r), scale) : 0ull;
            }
        }
    }
}

template <bool kQuant>
__global__ void __launch_bounds__(1024)
bin_scatter_kernel(const std::uint8_t* __restrict__ bins,    // (m, f, chunk) stack
                   const void* __restrict__ stats,            // (3, n) int8 | bf16 bits
                   const std::int32_t* __restrict__ node,     // (n,)
                   const double* __restrict__ scale,          // (3,), bf16 stats only
                   const std::int32_t* __restrict__ layout,   // offsets (f), widths (f),
                                                              // (first, last) feature per chunk
                   long long n, long long chunk, int f, int k_rows, int k, int chunk_rows,
                   long long rows_per_block,                  // a multiple of kRows
                   typename SharedAcc<kQuant>::Out* __restrict__ out)  // (k_pad, 3k), zeroed
{
    using T = typename SharedAcc<kQuant>::Value;
    extern __shared__ __align__(16) unsigned smem[];
    const int width = 3 * k;
    const int c0 = blockIdx.x * chunk_rows;
    const int nc = min(chunk_rows, k_rows - c0);
    const SharedAcc<kQuant> acc(smem, nc * width);  // (nc, 3k) cells
    const std::int32_t* offsets = layout;
    const std::int32_t* widths = layout + f;
    const int f_first = layout[2 * f + 2 * blockIdx.x];
    const int f_last = layout[2 * f + 2 * blockIdx.x + 1];

    mmlspark_packed::zero<kQuant>(smem, nc * width);
    double s0 = 0.0, s1 = 0.0, s2 = 0.0;
    if constexpr (!kQuant) {
        s0 = scale[0];
        s1 = scale[1];
        s2 = scale[2];
    }
    __syncthreads();

    const long long r0 = static_cast<long long>(blockIdx.y) * rows_per_block;
    const long long r1 = min(n, r0 + rows_per_block);
    const long long plane = static_cast<long long>(f) * chunk;  // bytes of one chunk
    const long long stride = static_cast<long long>(kRows) * blockDim.x;
    // Row i's place in the stack, chunk ci and column col, kept up to date
    // as i steps, with no division in the loop.
    long long i = r0 + kRows * threadIdx.x;
    long long ci = i / chunk;
    long long col = i - ci * chunk;
    for (; i < r1; i += stride, col += stride) {
        while (col >= chunk) {
            col -= chunk;
            ++ci;
        }
        const long long left = r1 - i;
        const bool full = left >= kRows;
        int key[kRows];
        if (full && aligned(node + i, 16)) {
            const int4 k4 = __ldg(reinterpret_cast<const int4*>(node + i));
            key[0] = k4.x; key[1] = k4.y; key[2] = k4.z; key[3] = k4.w;
        } else {
#pragma unroll
            for (int r = 0; r < kRows; ++r) {
                key[r] = r < left ? __ldg(node + i + r) : -1;
            }
        }
        bool any = false;
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
            if (key[r] < 0 || key[r] >= k) {
                key[r] = -1;
            }
            any |= key[r] >= 0;
        }
        if (!any) {
            continue;
        }
        T q0[kRows], q1[kRows], q2[kRows];
        load_stat<kQuant>(stats, i, full, left, s0, q0);
        load_stat<kQuant>(stats, n + i, full, left, s1, q1);
        load_stat<kQuant>(stats, 2 * n + i, full, left, s2, q2);

        // Row i's byte of feature 0 in the stack; the step stays in one
        // chunk unless it crosses a chunk's end.
        const bool one_chunk = full && col + kRows <= chunk;
        const std::uint8_t* row0 = bins + ci * plane + col;
        for (int ff = f_first; ff <= f_last; ++ff) {
            const std::uint8_t* p = row0 + static_cast<long long>(ff) * chunk;
            unsigned word = 0u;
            if (one_chunk && aligned(p, 4)) {
                word = __ldg(reinterpret_cast<const unsigned*>(p));
            } else {
#pragma unroll
                for (int r = 0; r < kRows; ++r) {
                    if (r < left) {
                        long long cr = ci, cc = col + r;
                        while (cc >= chunk) {  // past a chunk's end
                            cc -= chunk;
                            ++cr;
                        }
                        const std::uint8_t* pr =
                            bins + cr * plane + static_cast<long long>(ff) * chunk + cc;
                        word |= static_cast<unsigned>(__ldg(pr)) << (8 * r);
                    }
                }
            }
            const int base = __ldg(offsets + ff) - c0;
            const int w = __ldg(widths + ff);
#pragma unroll
            for (int r = 0; r < kRows; ++r) {
                const int bin = (word >> (8 * r)) & 0xFF;
                const int c = base + bin;
                if (key[r] < 0 || bin >= w || c < 0 || c >= nc) {
                    continue;
                }
                const int cell = c * width + key[r];
                acc.add(cell, q0[r]);
                acc.add(cell + k, q1[r]);
                acc.add(cell + 2 * k, q2[r]);
            }
        }
    }
    __syncthreads();
    mmlspark_packed::flush<kQuant>(acc, nc * width, out + static_cast<long long>(c0) * width);
}

template <bool kQuant>
int launch(const std::uint8_t* bins, const void* stats, const std::int32_t* node,
           const double* scale, const std::int32_t* layout, long long n, long long chunk, int f,
           int k_rows, int k, int chunk_rows, int grid_x, int grid_y, long long rows_per_block,
           int threads, int smem_bytes, void* out, cudaStream_t stream)
{
    cudaError_t err = cudaFuncSetAttribute(
        bin_scatter_kernel<kQuant>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
    if (err != cudaSuccess) {
        return static_cast<int>(err);
    }
    bin_scatter_kernel<kQuant><<<dim3(grid_x, grid_y), threads, smem_bytes, stream>>>(
        bins, stats, node, scale, layout, n, chunk, f, k_rows, k, chunk_rows, rows_per_block,
        static_cast<typename SharedAcc<kQuant>::Out*>(out));
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int mmlspark_bin_scatter_launch(const std::uint8_t* bins, const void* stats,
                                           const std::int32_t* node, const double* scale,
                                           const std::int32_t* layout, int quant, long long n,
                                           long long chunk, int f, int k_rows, int k,
                                           int chunk_rows, int grid_x, int grid_y,
                                           long long rows_per_block, int threads,
                                           int smem_bytes, void* out, void* stream)
{
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (quant) {
        return launch<true>(bins, stats, node, scale, layout, n, chunk, f, k_rows, k, chunk_rows,
                            grid_x, grid_y, rows_per_block, threads, smem_bytes, out, s);
    }
    return launch<false>(bins, stats, node, scale, layout, n, chunk, f, k_rows, k, chunk_rows,
                         grid_x, grid_y, rows_per_block, threads, smem_bytes, out, s);
}
