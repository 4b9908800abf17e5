// elim_sort — the elimination pre-pass's operation-log sort, for Hopper
// (sm_90a).
//
// Replaces the Pallas kernel `elim_sort_pallas`
// (src/repro/kernels/elim_match.py:42, body `_elim_sort_kernel` :34).  Each
// row of an (R, B) log of (masked insert key, lane tag) pairs is sorted
// ascending, lexicographic on (key, tag); with unique lane tags that is the
// stable sort by key the elimination match needs.  The row is treated as
// padded to next_pow2(B) with (INF, INT32_MAX) pads (the padding contract of
// src/repro/kernels/ops.py:124-133), which sort behind every real pair and
// are never written back.
//
// What bounds it on the card: bytes, 16 R B (two int32 words read and two
// written per lane, src/repro/kernels/registry.py:418-422): 32 KB at the
// main path's (K, B) = (64, 64), about 0.02 µs of device memory.  What
// costs time is the chain of dependent network stages; a block-wide sort
// in shared memory pays a `__syncthreads()` for each of them (21 at
// B = 64).
//
// Design, B <= 256: one warp per row, the row in registers.  Lane l holds
// words l P .. l P + P - 1 of the row padded to 32 P words, P =
// max(1, next_pow2(B) / 32) (`warp_bitonic.cuh`'s blocked layout; P = 2 at
// B = 64 and B = 57, P = 1 at B <= 32 with pads in the lanes past B).  The
// lane loads its P keys and tags (one 8- or 16-byte load each where the
// row is aligned and the lane's words are all below B, scalar loads
// otherwise), packs them into (key, tag) words, runs `warp_sort<P>` (strides
// below P inside the lane, wider ones through `__shfl_xor_sync` on the
// 64-bit word) and writes back its words below B.  No shared memory, no
// block barrier.  Four warps (rows) a block: 16 blocks of 128 threads at
// (64, 64).  Of 1, 2, 4 and 8 rows a block, 4 read fastest at (64, 64)
// and (84, 57), and 8 slowest (PERF.md, section 6).
//
// Rows wider than 256 words (up to kMaxRow) take the block body, a second
// kernel of this file (the kernel's first design, kept as it was): one
// block per row, the row in shared memory (8 next_pow2(B) bytes), the
// block-wide bitonic sort of `bitonic.cuh` with a barrier per stage.  The
// launcher chooses the body by B alone.

#include <cstdint>

#include "warp_bitonic.cuh"

using namespace repro_torch;

namespace {

constexpr int kMaxRow = 16384;  // 128 KB of packed words per row
constexpr int kRowsPerBlock = 4;

// A lane's P consecutive ints of `src` starting at element e0 (< n or
// not), into `out`; elements at or past n are `pad`.  One vector load
// (8 or 16 bytes, two of them at P = 8) where the lane's words are all
// below n and `src + e0` is aligned to them.
template <int P>
__device__ __forceinline__ void load_lane(int (&out)[P], const int* src,
                                          int e0, int n, int pad) {
  constexpr int kVec = P >= 4 ? 4 : P;  // ints a load
  const int* p = src + e0;
  if (kVec > 1 && e0 + P <= n &&
      (reinterpret_cast<uintptr_t>(p) & (kVec * sizeof(int) - 1)) == 0) {
    if constexpr (kVec == 4) {
#pragma unroll
      for (int r = 0; r < P; r += 4) {
        const int4 x = *reinterpret_cast<const int4*>(p + r);
        out[r] = x.x;
        out[r + 1] = x.y;
        out[r + 2] = x.z;
        out[r + 3] = x.w;
      }
    } else if constexpr (kVec == 2) {
      const int2 x = *reinterpret_cast<const int2*>(p);
      out[0] = x.x;
      out[1] = x.y;
    }
    return;
  }
#pragma unroll
  for (int r = 0; r < P; ++r) out[r] = e0 + r < n ? p[r] : pad;
}

// The store counterpart of `load_lane`: elements at or past n are not
// written.
template <int P>
__device__ __forceinline__ void store_lane(int* dst, const int (&in)[P],
                                           int e0, int n) {
  constexpr int kVec = P >= 4 ? 4 : P;
  int* p = dst + e0;
  if (kVec > 1 && e0 + P <= n &&
      (reinterpret_cast<uintptr_t>(p) & (kVec * sizeof(int) - 1)) == 0) {
    if constexpr (kVec == 4) {
#pragma unroll
      for (int r = 0; r < P; r += 4) {
        *reinterpret_cast<int4*>(p + r) =
            make_int4(in[r], in[r + 1], in[r + 2], in[r + 3]);
      }
    } else if constexpr (kVec == 2) {
      *reinterpret_cast<int2*>(p) = make_int2(in[0], in[1]);
    }
    return;
  }
#pragma unroll
  for (int r = 0; r < P; ++r) {
    if (e0 + r < n) p[r] = in[r];
  }
}

template <int P>
__global__ void __launch_bounds__(kRowsPerBlock * 32)
    elim_sort_warp_kernel(const int* __restrict__ keys,
                          const int* __restrict__ tags,
                          int* __restrict__ out_k, int* __restrict__ out_t,
                          int R, int B) {
  const size_t row = (size_t)blockIdx.x * kRowsPerBlock + (threadIdx.x >> 5);
  if (row >= (size_t)R) return;
  const int e0 = (threadIdx.x & 31) * P;
  int k[P], t[P];
  load_lane<P>(k, keys + row * B, e0, B, INT_MAX);
  load_lane<P>(t, tags + row * B, e0, B, INT_MAX);
  word_t v[P];
#pragma unroll
  for (int r = 0; r < P; ++r) v[r] = pack_kt(k[r], t[r]);
  warp_sort<P>(v, false);
#pragma unroll
  for (int r = 0; r < P; ++r) {
    k[r] = unpack_key(v[r]);
    t[r] = unpack_tag(v[r]);
  }
  store_lane<P>(out_k + row * B, k, e0, B);
  store_lane<P>(out_t + row * B, t, e0, B);
}

__global__ void elim_sort_block_kernel(const int* __restrict__ keys,
                                       const int* __restrict__ tags,
                                       int* __restrict__ out_k,
                                       int* __restrict__ out_t, int B,
                                       int Bp) {
  extern __shared__ word_t s[];
  const size_t row = blockIdx.x;
  const int* rk = keys + row * B;
  const int* rt = tags + row * B;
  for (int i = threadIdx.x; i < Bp; i += blockDim.x) {
    s[i] = i < B ? pack_kt(rk[i], rt[i]) : kPadWord;
  }
  __syncthreads();
  cta_bitonic_sort(s, Bp);
  for (int i = threadIdx.x; i < B; i += blockDim.x) {
    word_t w = s[i];
    out_k[row * B + i] = unpack_key(w);
    out_t[row * B + i] = unpack_tag(w);
  }
}

template <int P>
cudaError_t launch_warp(const int* keys, const int* tags, int* out_k,
                        int* out_t, int R, int B, cudaStream_t stream) {
  const int blocks = (R + kRowsPerBlock - 1) / kRowsPerBlock;
  elim_sort_warp_kernel<P><<<blocks, kRowsPerBlock * 32, 0, stream>>>(
      keys, tags, out_k, out_t, R, B);
  return cudaGetLastError();
}

}  // namespace

extern "C" int elim_sort_launch(const int* keys, const int* tags, int* out_k,
                                int* out_t, int R, int B, void* stream) {
  if (R <= 0 || B <= 0) return (int)cudaErrorInvalidValue;
  const int Bp = next_pow2(B);
  if (Bp > kMaxRow) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  switch (Bp <= 32 ? 1 : Bp / 32) {
    case 1:
      return (int)launch_warp<1>(keys, tags, out_k, out_t, R, B, st);
    case 2:
      return (int)launch_warp<2>(keys, tags, out_k, out_t, R, B, st);
    case 4:
      return (int)launch_warp<4>(keys, tags, out_k, out_t, R, B, st);
    case 8:
      return (int)launch_warp<8>(keys, tags, out_k, out_t, R, B, st);
    default:
      break;
  }
  const size_t smem = (size_t)Bp * sizeof(word_t);
  cudaError_t err = allow_smem(elim_sort_block_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  elim_sort_block_kernel<<<R, threads_for(Bp), smem, st>>>(keys, tags, out_k,
                                                           out_t, B, Bp);
  return (int)cudaGetLastError();
}

extern "C" const char* elim_sort_error(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
