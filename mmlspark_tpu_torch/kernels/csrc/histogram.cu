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
// nothing (the in-leaf mask convention of the leafwise grower), and so do
// bins at or past num_bins.
//
// Sums are exact and independent of order. g and h are summed in 64-bit
// fixed point: each value becomes the integer round(x * 2^s), with the power
// of two 2^s chosen per call by the wrapper (`fixed_point_scales` in
// ops/hopper_histogram.py) so that the sum of all N rows cannot overflow.
// Counts are non-negative integers whose cell sums stay below 2^24 (the
// grower passes ones), summed as uint32. The finalize pass turns each g and
// h sum back into float (int64 -> double -> float, round to nearest each
// time), and a count is exact in float32. The plain version
// (build_histograms_plain) does the same integer arithmetic, so kernel and
// plain version agree bit for bit, and two launches agree with each other.
//
// The TPU kernel built a one-hot in VMEM and contracted it on the MXU; a
// keyed scatter-add has no matrix-unit form worth taking on Hopper (the
// product does 256x the useful work), so this kernel privatizes the
// histogram in shared memory:
//
// - Exact 64-bit adds from 32-bit shared atomics. Hopper has no 64-bit
//   integer add on shared memory (the compiler makes a compare-and-swap
//   loop, ATOMS.CAST.SPIN.64, of it), so each cell's g and h are 64-bit
//   words kept as two uint32 halves and added with two native ATOMS.ADD:
//   old = atomicAdd(lo, (u32)q), then atomicAdd(hi, (u32)(q >> 32) + carry)
//   with carry = (old + (u32)q >= 2^32), skipped when it adds 0. Every lo
//   add's carry out lands in hi once, so the word ends as the sum mod 2^64
//   in any interleaving: exact. A cell is 20 bytes (g lo, g hi, h lo, h hi,
//   count), up to 210 KB of shared memory for one feature at 42 nodes x 256
//   bins.
// - Shared-memory layout for the banks. The five words are five planes of
//   uint32, so each of the five atomics of a row can use all 32 banks, and
//   a feature's cells are node-minor, (bin, node): the nodes of one bin sit
//   in consecutive words, on consecutive banks. In (node, bin) order the
//   copies of a bin would lie 256 words apart, on one bank, and a feature
//   with a few distinct bins (HIGGS's b-tag columns) would send a whole
//   warp's atomics to a few banks.
// - Grid (feature groups, row blocks). A block owns a group of `fg`
//   features, whose cells fit its shared memory, and a contiguous row range.
//   The group index varies fastest, so all groups of one row range run
//   together and every group after the first finds the range's g, h, c and
//   node in L2 instead of device memory.
// - Vector row walk. Each thread takes 4 consecutive rows a step: the key,
//   g, h and c with one 16-byte load each, the bins with one 32-bit load a
//   feature, and the fixed-point conversion once per row for the whole
//   group. A feature row whose start is not 4-byte aligned (N % 4 != 0)
//   and the last partial step of the range take byte loads instead; the
//   wrapper hands over 16-byte aligned stats and 4-byte aligned bins.
// - The block flushes its nonzero cells into zeroed int64 and float
//   accumulators in device memory with global atomicAdd (native at 64 bits
//   there); a second, elementwise kernel converts the int64 sums to float32.
//
// What bounds it: a pass must read each bin byte and each row's 16 bytes of
// (g, h, c, node) once, about 0.15 ms at 11M x 28 on an H100 at 3.35 TB/s.
// The kernel is several times slower than that: it does up to 5 shared
// atomics per keyed row and feature (the g and h high halves are nonzero
// for almost every row), and the shared-memory atomic rate, with the bank
// conflicts of a random scatter, bounds it.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

using u64 = unsigned long long;

// Rows a thread takes per step of its walk (one 16-byte load of each stat).
constexpr int kRows = 4;

__global__ void __launch_bounds__(1024)
hist_kernel(const std::uint8_t* __restrict__ bins_t,  // (F, N) feature-major, 4-byte aligned
            const float* __restrict__ grad,            // (N,), 16-byte aligned
            const float* __restrict__ hess,            // (N,), 16-byte aligned
            const float* __restrict__ count,           // (N,), 16-byte aligned
            const std::int32_t* __restrict__ node,     // (N,), 16-byte aligned
            const double* __restrict__ scale,          // (2,) powers of two for g, h
            long long n, int f, int k, int b, int fg,
            long long rows_per_block,                  // a multiple of kRows
            u64* __restrict__ acc,                     // (k, F, B, 2) int64, zeroed
            float* __restrict__ out)                   // (k, F, B, 3), zeroed
{
    extern __shared__ __align__(16) unsigned smem[];
    const int f0 = blockIdx.x * fg;
    const int nf = min(fg, f - f0);
    const int per_feature = k * b;
    const int total = nf * per_feature;
    // Five (nf, b, k) planes: g low and high halves, h low and high, count.
    unsigned* gl = smem;
    unsigned* gh = smem + total;
    unsigned* hl = smem + 2 * total;
    unsigned* hh = smem + 3 * total;
    unsigned* cs = smem + 4 * total;

    for (int j = threadIdx.x; j < 5 * total; j += blockDim.x) {
        smem[j] = 0u;
    }
    __syncthreads();

    const double sg = scale[0];
    const double sh = scale[1];
    const long long r0 = static_cast<long long>(blockIdx.y) * rows_per_block;
    const long long r1 = min(n, r0 + rows_per_block);
    for (long long i = r0 + kRows * threadIdx.x; i < r1; i += kRows * blockDim.x) {
        const bool full = i + kRows <= r1;
        int key[kRows];
        float gv[kRows], hv[kRows], cv[kRows];
        if (full) {
            const int4 k4 = __ldg(reinterpret_cast<const int4*>(node + i));
            const float4 g4 = __ldg(reinterpret_cast<const float4*>(grad + i));
            const float4 h4 = __ldg(reinterpret_cast<const float4*>(hess + i));
            const float4 c4 = __ldg(reinterpret_cast<const float4*>(count + i));
            key[0] = k4.x; key[1] = k4.y; key[2] = k4.z; key[3] = k4.w;
            gv[0] = g4.x; gv[1] = g4.y; gv[2] = g4.z; gv[3] = g4.w;
            hv[0] = h4.x; hv[1] = h4.y; hv[2] = h4.z; hv[3] = h4.w;
            cv[0] = c4.x; cv[1] = c4.y; cv[2] = c4.z; cv[3] = c4.w;
        } else {
#pragma unroll
            for (int r = 0; r < kRows; ++r) {
                const bool in = i + r < r1;
                key[r] = in ? node[i + r] : -1;
                gv[r] = in ? grad[i + r] : 0.0f;
                hv[r] = in ? hess[i + r] : 0.0f;
                cv[r] = in ? count[i + r] : 0.0f;
            }
        }
        bool keyed[kRows];
        bool any = false;
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
            keyed[r] = key[r] >= 0 && key[r] < k;
            any |= keyed[r];
        }
        if (!any) {
            continue;
        }
        // Per keyed row: its node, its g and h in fixed point as 32-bit
        // halves, its count. Two's complement: adding the unsigned image of
        // a signed value is signed addition mod 2^64.
        int row_node[kRows];
        unsigned glo[kRows], ghi[kRows], hlo[kRows], hhi[kRows], cnt[kRows];
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
            row_node[r] = keyed[r] ? key[r] : 0;
            const u64 qg = static_cast<u64>(__double2ll_rn(static_cast<double>(gv[r]) * sg));
            const u64 qh = static_cast<u64>(__double2ll_rn(static_cast<double>(hv[r]) * sh));
            glo[r] = static_cast<unsigned>(qg);
            ghi[r] = static_cast<unsigned>(qg >> 32);
            hlo[r] = static_cast<unsigned>(qh);
            hhi[r] = static_cast<unsigned>(qh >> 32);
            cnt[r] = static_cast<unsigned>(cv[r]);
        }
        for (int j = 0; j < nf; ++j) {
            const long long start = static_cast<long long>(f0 + j) * n + i;
            unsigned word = 0u;
            if (full && (start & 3) == 0) {
                word = __ldg(reinterpret_cast<const unsigned*>(bins_t + start));
            } else {
#pragma unroll
                for (int r = 0; r < kRows; ++r) {
                    if (i + r < r1) {
                        word |= static_cast<unsigned>(__ldg(bins_t + start + r)) << (8 * r);
                    }
                }
            }
            const int feature_cell = j * per_feature;
#pragma unroll
            for (int r = 0; r < kRows; ++r) {
                const int bin = (word >> (8 * r)) & 0xFF;
                if (!keyed[r] || bin >= b) {
                    continue;
                }
                const int cell = feature_cell + bin * k + row_node[r];
                const unsigned og = atomicAdd(gl + cell, glo[r]);
                const unsigned oh = atomicAdd(hl + cell, hlo[r]);
                atomicAdd(cs + cell, cnt[r]);
                // old + lo wrapped past 2^32 exactly when old > ~lo
                const unsigned gc = ghi[r] + (og > ~glo[r] ? 1u : 0u);
                const unsigned hc = hhi[r] + (oh > ~hlo[r] ? 1u : 0u);
                if (gc != 0u) {
                    atomicAdd(gh + cell, gc);
                }
                if (hc != 0u) {
                    atomicAdd(hh + cell, hc);
                }
            }
        }
    }
    __syncthreads();

    // In output order, (node, feature, bin), so neighbouring threads flush
    // neighbouring words of device memory.
    for (int j = threadIdx.x; j < total; j += blockDim.x) {
        const int fj = j / per_feature;
        const int rem = j - fj * per_feature;
        const int nd = rem / b;
        const int bin = rem - nd * b;
        const long long dst = (static_cast<long long>(nd) * f + f0 + fj) * b + bin;
        const int src = fj * per_feature + bin * k + nd;
        const u64 g = gl[src] | (static_cast<u64>(gh[src]) << 32);
        const u64 h = hl[src] | (static_cast<u64>(hh[src]) << 32);
        const unsigned c = cs[src];
        if (g != 0ull) {
            atomicAdd(acc + 2 * dst, g);
        }
        if (h != 0ull) {
            atomicAdd(acc + 2 * dst + 1, h);
        }
        if (c != 0u) {
            atomicAdd(out + 3 * dst + 2, __uint2float_rn(c));
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
                                    long long n, int f, int k, int b, int fg, int row_blocks,
                                    long long rows_per_block, int threads, int smem_bytes,
                                    unsigned long long* acc, float* out, void* stream)
{
    cudaError_t err = cudaFuncSetAttribute(
        hist_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
    if (err != cudaSuccess) {
        return static_cast<int>(err);
    }
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    const dim3 grid((f + fg - 1) / fg, row_blocks);
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
