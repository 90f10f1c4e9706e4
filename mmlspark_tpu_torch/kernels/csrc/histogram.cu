// Node-keyed gradient/hessian/count histogram for Hopper (sm_90a).
//
// Replaces the TPU kernel `_hist_kernel` in mmlspark_tpu/ops/pallas_histogram.py,
// reached there through `build_histograms_panel_pallas` (node-panel contract)
// and `build_histograms_pallas` (combined node*B + bin contract). Both
// contracts compute the same function, so one kernel serves both:
//
//   out[k, f, b, :] += [g_i, h_i, c_i]   for every row i with node_i = k,
//                                          bins[f, i] = b
//
// returned in float32. Rows whose node key lies outside [0, num_nodes) add
// nothing (the in-leaf mask convention of the leafwise grower).
//
// Sums are exact and independent of order. Float atomics land in a different
// order on every launch, and in float32 that order moves the g and h sums by
// a few ulps; a split whose gain ties its rival within that noise then goes
// either way, so two fits of the same data could grow different trees. So g
// and h are summed in 64-bit fixed point instead: each value becomes the
// integer round(x * 2^s), with the power of two 2^s chosen per call by the
// wrapper (`fixed_point_scales` in ops/hopper_histogram.py) so that the sum
// of all N rows cannot overflow, and integer addition is associative. The
// finalize pass turns each sum back into float (int64 -> double -> float,
// round to nearest each time). The rounding of g*2^s to an integer is the
// only loss: at most 2^-(s+1) a row, where 2^s is about 2^62 / (N * max|g|).
// Counts stay in float32 atomics: they are integers below 2^24 per cell,
// exact in any order. The plain version (build_histograms_plain) does the
// same integer arithmetic, so kernel and plain version agree bit for bit.
//
// What bounds it: one pass reads each bin byte and each row's 16 bytes of
// (g, h, c, node) once, so the floor is device-memory bandwidth. The TPU
// kernel built a one-hot in VMEM and contracted it on the MXU; a keyed
// scatter-add has no matrix-unit form worth taking on Hopper, so this kernel
// privatizes the histogram in shared memory instead:
//
// - grid (row blocks, feature groups); a block owns a contiguous row range
//   and a group of `fg` features whose num_nodes*B cells of (int64 g, int64
//   h, float c) all fit the block's dynamic shared memory (up to 210 KB at
//   42 nodes x 256 bins);
// - each thread walks rows with a block-wide stride (coalesced loads of the
//   feature-major uint8 bins and of g, h, c, node), converts the row's g and
//   h to fixed point once and adds them into every feature of the group with
//   shared-memory atomicAdd;
// - the block flushes its nonzero cells into zeroed int64 and float
//   accumulators in device memory with global atomicAdd;
// - a second, elementwise kernel converts the int64 sums to float32.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

using u64 = unsigned long long;

__global__ void __launch_bounds__(1024)
hist_kernel(const std::uint8_t* __restrict__ bins_t,  // (F, N) feature-major
            const float* __restrict__ grad,            // (N,)
            const float* __restrict__ hess,            // (N,)
            const float* __restrict__ count,           // (N,)
            const std::int32_t* __restrict__ node,     // (N,)
            const double* __restrict__ scale,          // (2,) powers of two for g, h
            long long n, int f, int k, int b, int fg, long long rows_per_block,
            u64* __restrict__ acc,                     // (k, F, B, 2) int64, zeroed
            float* __restrict__ out)                   // (k, F, B, 3), zeroed
{
    extern __shared__ u64 smem[];
    const int f0 = blockIdx.y * fg;
    const int nf = min(fg, f - f0);
    const int per_feature = k * b;
    const int total = nf * per_feature;
    u64* gh = smem;                                          // (nf, k, b, 2)
    float* cnt = reinterpret_cast<float*>(smem + 2 * total);  // (nf, k, b)

    for (int j = threadIdx.x; j < 2 * total; j += blockDim.x) {
        gh[j] = 0ull;
    }
    for (int j = threadIdx.x; j < total; j += blockDim.x) {
        cnt[j] = 0.0f;
    }
    __syncthreads();

    const double sg = scale[0];
    const double sh = scale[1];
    const long long r0 = static_cast<long long>(blockIdx.x) * rows_per_block;
    const long long r1 = min(n, r0 + rows_per_block);
    for (long long i = r0 + threadIdx.x; i < r1; i += blockDim.x) {
        const int nd = node[i];
        if (nd < 0 || nd >= k) {
            continue;
        }
        // Two's complement: adding the unsigned image of a signed value is
        // signed addition modulo 2^64.
        const u64 qg = static_cast<u64>(__double2ll_rn(static_cast<double>(grad[i]) * sg));
        const u64 qh = static_cast<u64>(__double2ll_rn(static_cast<double>(hess[i]) * sh));
        const float ci = count[i];
        const int row_cell = nd * b;
        for (int j = 0; j < nf; ++j) {
            const int bin = bins_t[static_cast<long long>(f0 + j) * n + i];
            if (bin >= b) {
                continue;
            }
            const int cell = j * per_feature + row_cell + bin;
            atomicAdd(gh + 2 * cell, qg);
            atomicAdd(gh + 2 * cell + 1, qh);
            atomicAdd(cnt + cell, ci);
        }
    }
    __syncthreads();

    for (int j = threadIdx.x; j < total; j += blockDim.x) {
        const int fj = j / per_feature;
        const int rem = j - fj * per_feature;
        const int nd = rem / b;
        const int bin = rem - nd * b;
        const long long dst = (static_cast<long long>(nd) * f + f0 + fj) * b + bin;
        const u64 g = gh[2 * j];
        const u64 h = gh[2 * j + 1];
        const float c = cnt[j];
        if (g != 0ull) {
            atomicAdd(acc + 2 * dst, g);
        }
        if (h != 0ull) {
            atomicAdd(acc + 2 * dst + 1, h);
        }
        if (c != 0.0f) {
            atomicAdd(out + 3 * dst + 2, c);
        }
    }
}

__global__ void hist_finalize(const u64* __restrict__ acc, const double* __restrict__ scale,
                              long long cells, float* __restrict__ out)
{
    const double sg = scale[0];
    const double sh = scale[1];
    for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
         i < cells; i += static_cast<long long>(gridDim.x) * blockDim.x) {
        const long long g = static_cast<long long>(acc[2 * i]);
        const long long h = static_cast<long long>(acc[2 * i + 1]);
        out[3 * i] = __double2float_rn(__ll2double_rn(g) / sg);
        out[3 * i + 1] = __double2float_rn(__ll2double_rn(h) / sh);
    }
}

}  // namespace

extern "C" int mmlspark_hist_launch(const std::uint8_t* bins_t, const float* grad,
                                    const float* hess, const float* count,
                                    const std::int32_t* node, const double* scale,
                                    long long n, int f, int k, int b, int fg, int grid_x,
                                    long long rows_per_block, int threads, int smem_bytes,
                                    unsigned long long* acc, float* out, void* stream)
{
    cudaError_t err = cudaFuncSetAttribute(
        hist_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
    if (err != cudaSuccess) {
        return static_cast<int>(err);
    }
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    const dim3 grid(grid_x, (f + fg - 1) / fg);
    hist_kernel<<<grid, threads, smem_bytes, s>>>(
        bins_t, grad, hess, count, node, scale, n, f, k, b, fg, rows_per_block, acc, out);
    err = cudaGetLastError();
    if (err != cudaSuccess) {
        return static_cast<int>(err);
    }
    const long long cells = static_cast<long long>(k) * f * b;
    const int fin_threads = 256;
    const long long fin_blocks = (cells + fin_threads - 1) / fin_threads;
    hist_finalize<<<static_cast<int>(fin_blocks < 4096 ? fin_blocks : 4096), fin_threads, 0, s>>>(
        acc, scale, cells, out);
    return static_cast<int>(cudaGetLastError());
}

extern "C" const char* mmlspark_hist_error_string(int code)
{
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}
