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
//
// A block keeps its cells in shared memory (SharedAcc), in the node-minor
// (c, s, key) order of the global accumulator: the nodes of one packed row
// sit on consecutive words, so rows of different nodes in one bin spread
// over the banks. Hopper has no 64-bit integer add on shared memory (the
// compiler makes a compare-and-swap loop, ATOMS.CAST.SPIN.64, of an
// atomicAdd on a 64-bit shared word), so a 64-bit cell is two uint32 words
// in two planes, low halves then high halves, each added with a native
// 32-bit ATOMS.ADD:
//
//   old = atomicAdd(lo, (u32)q);  carry = (old + (u32)q >= 2^32)
//   atomicAdd(hi, (u32)(q >> 32) + carry)
//
// Every carry out of a low add lands in the high word once, so the pair ends
// as the sum mod 2^64 in any interleaving: exact. A half that adds 0 is
// skipped (a count of 1 at these scales has a zero low half; a negative
// value whose carry wraps its high half to 0 needs no high add).
// Separate planes let each of the two atomics of a warp use all 32 banks.
// The flush recombines the halves and adds them to the global int64
// accumulator with the native 64-bit global atomicAdd.

#pragma once

#include <cstdint>

#include <cuda_runtime.h>

namespace mmlspark_packed {

using u64 = unsigned long long;

template <bool kQuant>
struct SharedAcc;

// int32 cells: one plane.
template <>
struct SharedAcc<true> {
    using Value = int;
    using Out = int;
    static constexpr int kWords = 1;  // uint32 words a cell takes

    int* cells;

    __device__ __forceinline__ SharedAcc(unsigned* smem, int /*n*/)
        : cells(reinterpret_cast<int*>(smem)) {}

    __device__ __forceinline__ void add(int idx, int v) const { atomicAdd(cells + idx, v); }

    __device__ __forceinline__ Value get(int idx) const { return cells[idx]; }
};

// int64 cells (two's complement, so unsigned adds are signed adds mod
// 2^64): a plane of low halves and a plane of high halves.
template <>
struct SharedAcc<false> {
    using Value = u64;
    using Out = u64;
    static constexpr int kWords = 2;

    unsigned* lo;
    unsigned* hi;

    __device__ __forceinline__ SharedAcc(unsigned* smem, int n) : lo(smem), hi(smem + n) {}

    __device__ __forceinline__ void add(int idx, u64 v) const
    {
        const unsigned ql = static_cast<unsigned>(v);
        unsigned qh = static_cast<unsigned>(v >> 32);
        if (ql != 0u) {
            const unsigned old = atomicAdd(lo + idx, ql);
            qh += old > ~ql ? 1u : 0u;  // old + ql wrapped past 2^32
        }
        if (qh != 0u) {
            atomicAdd(hi + idx, qh);
        }
    }

    __device__ __forceinline__ Value get(int idx) const
    {
        return static_cast<u64>(lo[idx]) | (static_cast<u64>(hi[idx]) << 32);
    }
};

// Zeroes a block's `n` cells (all planes).
template <bool kQuant>
__device__ __forceinline__ void zero(unsigned* smem, int n)
{
    for (int j = threadIdx.x; j < SharedAcc<kQuant>::kWords * n; j += blockDim.x) {
        smem[j] = 0u;
    }
}

// Adds a block's nonzero shared-memory cells into the zeroed global
// accumulator; `out` points at the block's first cell there.
template <bool kQuant>
__device__ __forceinline__ void flush(const SharedAcc<kQuant>& acc, int n,
                                      typename SharedAcc<kQuant>::Out* out)
{
    for (int j = threadIdx.x; j < n; j += blockDim.x) {
        const auto v = acc.get(j);
        if (v != 0) {
            atomicAdd(out + j, v);
        }
    }
}

// The integer a kernel sums for one stat value: an int8 as is, or a bf16
// (given as its 16 bits) times its stat's 2^s, rounded to nearest even like
// torch.round in the plain versions.
__device__ __forceinline__ int quant_value(std::int8_t x) { return static_cast<int>(x); }

__device__ __forceinline__ u64 fixed_value(std::uint16_t bits, double scale)
{
    const float x = __uint_as_float(static_cast<unsigned>(bits) << 16);
    return static_cast<u64>(__double2ll_rn(static_cast<double>(x) * scale));
}

// Element `idx` of the (3, n) stats as the integer the kernels sum.
template <bool kQuant>
__device__ __forceinline__ typename SharedAcc<kQuant>::Value stat_value(const void* stats,
                                                                        long long idx,
                                                                        double scale)
{
    if constexpr (kQuant) {
        return quant_value(static_cast<const std::int8_t*>(stats)[idx]);
    } else {
        return fixed_value(static_cast<const std::uint16_t*>(stats)[idx], scale);
    }
}

}  // namespace mmlspark_packed
