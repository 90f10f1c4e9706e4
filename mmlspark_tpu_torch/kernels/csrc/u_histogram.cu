// Contraction of the packed one-hot U with the node-keyed stat panel, for
// Hopper (sm_90a).
//
// Replaces the TPU kernel `_fused_panel_dot` (inner `kern`) in
// mmlspark_tpu/ops/u_histogram.py, the fused form of the U pass of
// `build_histograms_u`:
//
//   acc[c, s*k + j] += U[c, i] * stat_s[i]    for every row i with node_i = j
//
// U is (K_pad, N_pad) uint8, 0/1, packed rows leading; rows whose key lies
// outside [0, k) add nothing. Sums are exact integers (packed_hist.cuh), so
// the result equals the plain version (fused_panel_dot_plain) bit for bit.
//
// What bounds it: U has one set byte per feature in each row's column, so of
// the K_pad bytes a row (7,168 at 28 features x 256 bins) only F add
// anything, against 10 bytes of stats and key. The pass is bound by reading
// U once from device memory. The TPU kernel contracted a U tile with the
// panel on the MXU; here a set byte is rare, so the kernel reads U as fast
// as it can and adds only where a byte is set:
//
// - grid (packed-row chunks, row groups); a block owns `chunk_rows` packed
//   rows, whose (chunk_rows, 3k) accumulator lives in shared memory, and a
//   range of row tiles. The chunk index varies fastest, so the blocks that
//   read one row range's stats run together and find them in L2;
// - per tile of 2048 rows, the block first writes each row's key and its
//   three integer stats into shared memory (the panel, built once per tile);
// - then each warp takes a packed row and reads its 2048 bytes of the tile
//   as four 16-byte loads per lane, all in flight together. A vector that is
//   all zero (most are) costs nothing more; for each set byte the lane adds
//   the row's three stats into the cells of its key with shared-memory
//   atomics;
// - the block flushes its nonzero cells into the zeroed global accumulator
//   with atomics.

#include <cstdint>

#include <cuda_runtime.h>

#include "packed_hist.cuh"

namespace {

using mmlspark_packed::Acc;
using mmlspark_packed::atomic_add;
using mmlspark_packed::stat_value;

constexpr int kTileRows = 2048;
constexpr int kVecPerLane = kTileRows / (32 * 16);

template <bool kQuant>
__global__ void __launch_bounds__(1024)
u_panel_dot_kernel(const std::uint8_t* __restrict__ u,  // (k_pad, n_pad)
                   const void* __restrict__ stats,       // (3, n) int8 | bf16 bits
                   const std::int32_t* __restrict__ node,  // (n,)
                   const double* __restrict__ scale,       // (3,), bf16 stats only
                   long long n, long long n_pad, int k_pad, int k, int chunk_rows,
                   long long rows_per_block,
                   typename Acc<kQuant>::T* __restrict__ out)  // (k_pad, 3k), zeroed
{
    using T = typename Acc<kQuant>::T;
    extern __shared__ __align__(16) unsigned char smem_raw[];
    const int width = 3 * k;
    T* acc = reinterpret_cast<T*>(smem_raw);                 // (chunk_rows, 3k)
    T* q = acc + chunk_rows * width;                         // (3, kTileRows)
    int* key_of = reinterpret_cast<int*>(q + 3 * kTileRows);  // (kTileRows,)

    const int c0 = blockIdx.x * chunk_rows;
    const int nc = min(chunk_rows, k_pad - c0);
    for (int j = threadIdx.x; j < nc * width; j += blockDim.x) {
        acc[j] = T(0);
    }
    double s0 = 0.0, s1 = 0.0, s2 = 0.0;
    if constexpr (!kQuant) {
        s0 = scale[0];
        s1 = scale[1];
        s2 = scale[2];
    }

    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    const int warps = blockDim.x >> 5;
    const long long r0 = static_cast<long long>(blockIdx.y) * rows_per_block;
    const long long r1 = min(n_pad, r0 + rows_per_block);
    for (long long t0 = r0; t0 < r1; t0 += kTileRows) {
        const int tn = static_cast<int>(min(static_cast<long long>(kTileRows), r1 - t0));
        __syncthreads();  // the previous tile's readers are done
        for (int j = threadIdx.x; j < tn; j += blockDim.x) {
            const long long i = t0 + j;
            int key = -1;
            if (i < n) {
                key = node[i];
                if (key < 0 || key >= k) {
                    key = -1;
                }
            }
            key_of[j] = key;
            if (key >= 0) {
                q[j] = stat_value<kQuant>(stats, i, s0);
                q[kTileRows + j] = stat_value<kQuant>(stats, n + i, s1);
                q[2 * kTileRows + j] = stat_value<kQuant>(stats, 2 * n + i, s2);
            }
        }
        __syncthreads();
        for (int c = warp; c < nc; c += warps) {
            const std::uint8_t* row = u + static_cast<long long>(c0 + c) * n_pad + t0;
            uint4 v[kVecPerLane];
#pragma unroll
            for (int p = 0; p < kVecPerLane; ++p) {
                const int off = (p * 32 + lane) * 16;
                v[p] = off < tn ? __ldcs(reinterpret_cast<const uint4*>(row + off))
                                : make_uint4(0u, 0u, 0u, 0u);
            }
            T* cells = acc + c * width;
#pragma unroll
            for (int p = 0; p < kVecPerLane; ++p) {
                const unsigned words[4] = {v[p].x, v[p].y, v[p].z, v[p].w};
                if ((words[0] | words[1] | words[2] | words[3]) == 0u) {
                    continue;
                }
                const int base = (p * 32 + lane) * 16;
                for (int w = 0; w < 4; ++w) {
                    unsigned word = words[w];
                    while (word != 0u) {
                        const int byte = (__ffs(word) - 1) >> 3;
                        word &= ~(0xFFu << (8 * byte));
                        const int r = base + 4 * w + byte;
                        const int key = key_of[r];
                        if (key < 0) {
                            continue;
                        }
                        atomic_add(cells + key, q[r]);
                        atomic_add(cells + k + key, q[kTileRows + r]);
                        atomic_add(cells + 2 * k + key, q[2 * kTileRows + r]);
                    }
                }
            }
        }
    }
    __syncthreads();
    mmlspark_packed::flush(acc, nc * width, out + static_cast<long long>(c0) * width);
}

template <bool kQuant>
int launch(const std::uint8_t* u, const void* stats, const std::int32_t* node,
           const double* scale, long long n, long long n_pad, int k_pad, int k, int chunk_rows,
           int grid_x, int grid_y, long long rows_per_block, int threads, int smem_bytes,
           void* out, cudaStream_t stream)
{
    cudaError_t err = cudaFuncSetAttribute(
        u_panel_dot_kernel<kQuant>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
    if (err != cudaSuccess) {
        return static_cast<int>(err);
    }
    u_panel_dot_kernel<kQuant><<<dim3(grid_x, grid_y), threads, smem_bytes, stream>>>(
        u, stats, node, scale, n, n_pad, k_pad, k, chunk_rows, rows_per_block,
        static_cast<typename Acc<kQuant>::T*>(out));
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int mmlspark_u_panel_dot_launch(const std::uint8_t* u, const void* stats,
                                           const std::int32_t* node, const double* scale,
                                           int quant, long long n, long long n_pad, int k_pad,
                                           int k, int chunk_rows, int grid_x, int grid_y,
                                           long long rows_per_block, int threads,
                                           int smem_bytes, void* out, void* stream)
{
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (quant) {
        return launch<true>(u, stats, node, scale, n, n_pad, k_pad, k, chunk_rows, grid_x,
                            grid_y, rows_per_block, threads, smem_bytes, out, s);
    }
    return launch<false>(u, stats, node, scale, n, n_pad, k_pad, k, chunk_rows, grid_x, grid_y,
                         rows_per_block, threads, smem_bytes, out, s);
}
