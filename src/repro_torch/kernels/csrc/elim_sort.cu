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
// written per lane, src/repro/kernels/registry.py:418-422); the network does
// (B/2) log2 B (log2 B + 1) / 2 compare-exchanges per row in shared memory.
// At the main path's (K, B) = (64, 64) the whole log is 32 KB and the
// launch, not the card, sets the time.
//
// Design: one thread block per row (one window step), the row loaded once
// into shared memory as packed (key, tag) words, one full bitonic sort, one
// write back.

#include "bitonic.cuh"

using namespace repro_torch;

namespace {

constexpr int kMaxRow = 16384;  // 128 KB of packed words per row

__global__ void elim_sort_kernel(const int* __restrict__ keys,
                                 const int* __restrict__ tags,
                                 int* __restrict__ out_k,
                                 int* __restrict__ out_t, int B, int Bp) {
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

}  // namespace

extern "C" int elim_sort_launch(const int* keys, const int* tags, int* out_k,
                                int* out_t, int R, int B, void* stream) {
  if (R <= 0 || B <= 0) return (int)cudaErrorInvalidValue;
  const int Bp = next_pow2(B);
  if (Bp > kMaxRow) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)Bp * sizeof(word_t);
  cudaError_t err = allow_smem(elim_sort_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  elim_sort_kernel<<<R, threads_for(Bp), smem, (cudaStream_t)stream>>>(
      keys, tags, out_k, out_t, B, Bp);
  return (int)cudaGetLastError();
}

extern "C" const char* elim_sort_error(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
