// Pieces shared by the packed-space ("U") histogram kernels, u_histogram.cu
// and bin_scatter.cu. Both add each keyed row's three stats into a
// (K_pad, 3k) accumulator, cell [c, s*k + key], in integers:
//
// - quantized stats (int8, |x| <= 127) add in int32: a cell's sum is at
//   most 127 * 2^24 < 2^31 below the 2^24-row cap of the quantized path;
// - bf16 stats add as the int64 round(x * 2^s), with one power of two 2^s
//   per stat chosen by the wrapper (fixed_point_scales in
//   ops/hopper_histogram.py) so that the sum of all N rows cannot overflow.
//
// Integer addition is associative, so a sum does not depend on the order of
// rows or atomics: two launches agree bit for bit, and so do the kernels and
// their plain versions, which do the same integer arithmetic.

#pragma once

#include <cstdint>

#include <cuda_runtime.h>

namespace mmlspark_packed {

using u64 = unsigned long long;

template <bool kQuant>
struct Acc {
    using T = u64;  // two's complement: unsigned adds are signed adds mod 2^64
};

template <>
struct Acc<true> {
    using T = int;
};

__device__ __forceinline__ void atomic_add(int* p, int v) { atomicAdd(p, v); }

__device__ __forceinline__ void atomic_add(u64* p, u64 v) { atomicAdd(p, v); }

// Element `idx` of the (3, n) stats as the integer the kernels sum: an int8
// as is, or a bf16 (given as its 16 bits) times its stat's 2^s, rounded to
// nearest even like torch.round in the plain versions.
template <bool kQuant>
__device__ __forceinline__ typename Acc<kQuant>::T stat_value(const void* stats, long long idx,
                                                              double scale)
{
    if constexpr (kQuant) {
        return static_cast<int>(static_cast<const std::int8_t*>(stats)[idx]);
    } else {
        const unsigned bits =
            static_cast<unsigned>(static_cast<const std::uint16_t*>(stats)[idx]) << 16;
        return static_cast<u64>(
            __double2ll_rn(static_cast<double>(__uint_as_float(bits)) * scale));
    }
}

// Adds a block's nonzero shared-memory cells into the zeroed global
// accumulator; `out` points at the block's first cell there.
template <typename T>
__device__ __forceinline__ void flush(const T* acc, int cells, T* out)
{
    for (int j = threadIdx.x; j < cells; j += blockDim.x) {
        const T v = acc[j];
        if (v != T(0)) {
            atomic_add(out + j, v);
        }
    }
}

}  // namespace mmlspark_packed
