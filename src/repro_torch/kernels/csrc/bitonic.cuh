// Shared-memory bitonic networks on packed 64-bit (key, tag) words.
//
// CUDA counterpart of the network primitives in
// src/repro/kernels/bitonic_topk.py (`_cmp_exchange_asc`, `bitonic_sort`;
// `warp_bitonic.cuh` has `clean_bitonic`).  The network kernels of this
// package keep a row in shared memory or registers as packed words
//
//     ((uint32)(key ^ 0x80000000) << 32) | (uint32)(tag ^ 0x80000000)
//
// so that one unsigned 64-bit compare is the signed lexicographic order on
// (key, tag), the order the Pallas networks and the plain versions use.  The
// pad word (INT32_MAX, INT32_MAX) packs to all ones: the largest word, so
// pads sort behind every real (key, tag) pair.
//
// One thread block owns one row; `n` is a power of two and the block's
// threads stride over the n/2 compare-exchange pairs of each stage, with a
// barrier between stages.  `warp_bitonic.cuh` has the warp-level networks.
// The rank merges (`windowed_merge.cu`, `merge_sorted.cu`) run no network
// and take only the words, `rank_in` and `allow_smem` from here.
#pragma once

#include <climits>
#include <cstdint>

#include <cuda_runtime.h>

namespace repro_torch {

typedef unsigned long long word_t;

constexpr word_t kPadWord = ~0ULL;

__device__ __forceinline__ word_t pack_kt(int key, int tag) {
  return ((word_t)((unsigned)key ^ 0x80000000u) << 32) |
         (word_t)((unsigned)tag ^ 0x80000000u);
}

__device__ __forceinline__ int unpack_key(word_t w) {
  return (int)((unsigned)(w >> 32) ^ 0x80000000u);
}

__device__ __forceinline__ int unpack_tag(word_t w) {
  return (int)((unsigned)(w & 0xFFFFFFFFull) ^ 0x80000000u);
}

// Index of the lower element of compare-exchange pair `i` at stride `j`
// (j a power of two): pairs are (lo, lo + j) inside blocks of 2j.
__device__ __forceinline__ int pair_lo(int i, int j) {
  return ((i & ~(j - 1)) << 1) | (i & (j - 1));
}

// Full ascending sort of s[0, n) (`bitonic_sort`): the classic network with
// the stage direction taken from bit k of the lower index.  The caller has
// synchronised after writing s.
__device__ __forceinline__ void cta_bitonic_sort(word_t* s, int n) {
  for (int k = 2; k <= n; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int i = threadIdx.x; i < (n >> 1); i += blockDim.x) {
        int lo = pair_lo(i, j);
        word_t a = s[lo], b = s[lo + j];
        bool ascending = (lo & k) == 0;
        if ((a > b) == ascending) {
          s[lo] = b;
          s[lo + j] = a;
        }
      }
      __syncthreads();
    }
  }
}

// #{s[0, n) < x} (`strict`) or #{s[0, n) <= x}, s ascending (int keys or
// packed words): a binary search by descending powers of two, the same
// trip count on every lane.
template <typename T>
__device__ __forceinline__ int rank_in(const T* __restrict__ s, int n, T x,
                                       bool strict) {
  int lo = 0;
  for (int step = n ? 1 << (31 - __clz(n)) : 0; step > 0; step >>= 1) {
    const int j = lo + step;
    if (j <= n) {
      const T y = s[j - 1];
      if (strict ? y < x : y <= x) lo = j;
    }
  }
  return lo;
}

inline int next_pow2(int n) {
  int p = 1;
  while (p < n) p <<= 1;
  return p;
}

// Threads per row block: one per compare-exchange pair, at least a warp,
// at most 1024.
inline int threads_for(int n) {
  int t = n >> 1;
  if (t < 32) t = 32;
  if (t > 1024) t = 1024;
  return t;
}

// Opt a kernel in to more than the 48 KB of shared memory a block gets
// without asking (Hopper allows up to 227 KB of dynamic shared memory).
template <typename Kernel>
inline cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

}  // namespace repro_torch
