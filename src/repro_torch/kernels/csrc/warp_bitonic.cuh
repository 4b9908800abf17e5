// Warp-level bitonic networks on packed 64-bit (key, tag) words.
//
// The warp counterparts of the block-wide networks in `bitonic.cuh`: one
// warp sorts, cleans and folds a run of W words with no block barrier, and
// the warps of a block fold their runs into one with a barrier per level
// (`block_fold`).  Two homes for the run:
//
//   * registers, W = 32 P words, P per lane in the blocked layout: lane l
//     holds elements l P .. l P + P - 1.  A compare-exchange at stride j < P
//     stays inside the lane; at stride j >= P the partner is lane
//     l ^ (j / P), reached with `__shfl_xor_sync`;
//   * shared memory, for runs too wide for registers: the lanes stride over
//     the W/2 pairs of each stage, with `__syncwarp()` between stages.
//
// Words pack and order as in `bitonic.cuh`: one unsigned 64-bit compare is
// the signed lexicographic order on (key, tag).
#pragma once

#include "bitonic.cuh"

namespace repro_torch {

constexpr unsigned kFullMask = 0xFFFFFFFFu;
constexpr int kMaxWarps = 32;  // warps of a block
constexpr int kRegRun = 256;   // widest register run: 8 words a lane
// Shared memory of a block whose runs live in shared memory (W > kRegRun).
constexpr size_t kWideSmem = 192 * 1024;

__host__ __device__ constexpr int log2_of(int n) {
  return n > 1 ? 1 + log2_of(n >> 1) : 0;
}

// One stage (k, j) of the bitonic network on a register run: element e is
// in an ascending block of size k when (e & k) == 0, flipped by `desc`.
// `clean` stages (the merge of a bitonic run) are all ascending.
template <int P>
__device__ __forceinline__ void warp_stage(word_t (&v)[P], int k, int j,
                                           bool desc, bool clean) {
  const int lane = threadIdx.x & 31;
  if (j < P) {
#pragma unroll
    for (int r = 0; r < P; ++r) {
      if (r & j) continue;
      const int e = lane * P + r;
      const bool asc = clean || (((e & k) == 0) != desc);
      const word_t a = v[r], b = v[r | j];
      if ((a > b) == asc) {
        v[r] = b;
        v[r | j] = a;
      }
    }
  } else {
    const int lm = j / P;
    const bool lo = (lane & lm) == 0;
#pragma unroll
    for (int r = 0; r < P; ++r) {
      const int e = lane * P + r;
      const bool asc = clean || (((e & k) == 0) != desc);
      const word_t o = __shfl_xor_sync(kFullMask, v[r], lm);
      const word_t mn = o < v[r] ? o : v[r];
      const word_t mx = o < v[r] ? v[r] : o;
      v[r] = (lo == asc) ? mn : mx;
    }
  }
}

// Full sort of a register run of W = 32 P words, ascending or (`desc`)
// descending (`bitonic_sort`).
template <int P>
__device__ __forceinline__ void warp_sort(word_t (&v)[P], bool desc) {
  constexpr int kLog = log2_of(32 * P);
#pragma unroll
  for (int lk = 1; lk <= kLog; ++lk) {
#pragma unroll
    for (int lj = lk - 1; lj >= 0; --lj) {
      warp_stage<P>(v, 1 << lk, 1 << lj, desc, false);
    }
  }
}

// Ascending sort of a bitonic register run (`clean_bitonic`).
template <int P>
__device__ __forceinline__ void warp_clean(word_t (&v)[P]) {
  constexpr int kLog = log2_of(32 * P);
#pragma unroll
  for (int lj = kLog - 1; lj >= 0; --lj) {
    warp_stage<P>(v, 0, 1 << lj, false, true);
  }
}

// The same networks on a run s[0, W) in shared memory, W a power of two.
// The caller has synchronised the warp after writing s; each returns
// after a `__syncwarp()`.
__device__ __forceinline__ void warp_smem_sort(word_t* s, int W, bool desc) {
  const int lane = threadIdx.x & 31;
  for (int k = 2; k <= W; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int i = lane; i < (W >> 1); i += 32) {
        const int lo = pair_lo(i, j);
        const word_t a = s[lo], b = s[lo + j];
        if ((a > b) == (((lo & k) == 0) != desc)) {
          s[lo] = b;
          s[lo + j] = a;
        }
      }
      __syncwarp();
    }
  }
}

__device__ __forceinline__ void warp_smem_clean(word_t* s, int W) {
  const int lane = threadIdx.x & 31;
  for (int j = W >> 1; j > 0; j >>= 1) {
    for (int i = lane; i < (W >> 1); i += 32) {
      const int lo = pair_lo(i, j);
      const word_t a = s[lo], b = s[lo + j];
      if (a > b) {
        s[lo] = b;
        s[lo + j] = a;
      }
    }
    __syncwarp();
  }
}

// Fold every warp's ascending register run into warp 0's, which then holds
// the W = 32 P smallest words of them all, ascending: the pairwise
// `bitonic_merge_topk` step in ceil(log2 warps) levels, one
// `__syncthreads()` each.  The upper warp of a pair leaves its run reversed
// in `slots` (W words a warp); the lower warp takes the elementwise min, a
// bitonic sequence holding the W smallest of both runs, and cleans it.
// Every thread of the block calls it.
template <int P>
__device__ __forceinline__ void block_fold(word_t (&acc)[P], word_t* slots) {
  constexpr int W = 32 * P;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int warps = blockDim.x >> 5;
  for (int h = 1; h < warps; h <<= 1) {
    if ((warp & (2 * h - 1)) == h) {
      word_t* slot = slots + (size_t)warp * W;
#pragma unroll
      for (int r = 0; r < P; ++r) slot[W - 1 - (lane * P + r)] = acc[r];
    }
    __syncthreads();
    if ((warp & (2 * h - 1)) == 0 && warp + h < warps) {
      const word_t* slot = slots + (size_t)(warp + h) * W;
#pragma unroll
      for (int r = 0; r < P; ++r) {
        const word_t o = slot[lane * P + r];
        acc[r] = o < acc[r] ? o : acc[r];
      }
      warp_clean<P>(acc);
    }
  }
}

// The same fold for ascending runs of W words in shared memory, warp w's
// at runs + w * stride; warp 0's run holds the result.
__device__ __forceinline__ void block_fold_smem(word_t* runs, size_t stride,
                                                int W) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int warps = blockDim.x >> 5;
  word_t* acc = runs + (size_t)warp * stride;
  for (int h = 1; h < warps; h <<= 1) {
    __syncthreads();
    if ((warp & (2 * h - 1)) == 0 && warp + h < warps) {
      const word_t* up = runs + (size_t)(warp + h) * stride;
      for (int e = lane; e < W; e += 32) {
        const word_t o = up[W - 1 - e];
        if (o < acc[e]) acc[e] = o;
      }
      __syncwarp();
      warp_smem_clean(acc, W);
    }
  }
}

}  // namespace repro_torch
