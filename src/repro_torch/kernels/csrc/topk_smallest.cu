// topk_smallest — the deleteMin tournament, for Hopper (sm_90a).
//
// Replaces the Pallas kernel `topk_smallest_pallas`
// (src/repro/kernels/bitonic_topk.py:128, body `_topk_kernel` :110).  For
// every row of an (R, N) batch it returns the k lexicographically smallest
// (key, val) pairs, ascending; callers pass unique position tags as vals.
// The row is treated as padded to Np = max(next_pow2(N), next_pow2(k)), a
// multiple of the power-of-two k' = next_pow2(k) (the padding contract of
// src/repro/kernels/ops.py:82-94), with (INT32_MAX, INT32_MAX) pads, which
// sort behind every real pair.  min(k, N) columns are written.
//
// What bounds it on the card: bytes.  Each row reads 2 N words and writes
// 2 k words (src/repro/kernels/registry.py:412-415); the network work is
// O(N log^2 min(N, 4096)) compare-exchanges in shared memory, a few
// microseconds of one SM at the main path's N <= 2048.
//
// Design: one thread block per row.  The padded row is taken in chunks of
// up to 4096 words: each chunk is loaded once into shared memory as packed
// (key, val) words and fully bitonic-sorted; the first chunk's k' smallest
// start the accumulator, and each further chunk's k' smallest fold in by
// the `bitonic_merge_topk` step (elementwise min of the accumulator and the
// reversed chunk prefix, then a clean merge of k' words).  At the main
// path's shapes (N = 1424, 512, 128) the row is one chunk and the kernel is
// one sort of the padded row in shared memory.

#include "bitonic.cuh"

using namespace repro_torch;

namespace {

constexpr int kChunk = 4096;  // 32 KB of packed words

__global__ void topk_smallest_kernel(const int* __restrict__ keys,
                                     const int* __restrict__ vals,
                                     int* __restrict__ out_k,
                                     int* __restrict__ out_v, int N, int kp,
                                     int kout, int chunk, int n_chunks) {
  extern __shared__ word_t smem[];
  word_t* buf = smem;          // chunk words
  word_t* acc = smem + chunk;  // kp words
  const size_t row = blockIdx.x;
  const int* rk = keys + row * N;
  const int* rv = vals + row * N;

  for (int c = 0; c < n_chunks; ++c) {
    const int base = c * chunk;
    for (int i = threadIdx.x; i < chunk; i += blockDim.x) {
      int g = base + i;
      buf[i] = g < N ? pack_kt(rk[g], rv[g]) : kPadWord;
    }
    __syncthreads();
    cta_bitonic_sort(buf, chunk);
    if (c == 0) {
      for (int i = threadIdx.x; i < kp; i += blockDim.x) acc[i] = buf[i];
      __syncthreads();
    } else {
      for (int i = threadIdx.x; i < kp; i += blockDim.x) {
        word_t b = buf[kp - 1 - i];
        if (b < acc[i]) acc[i] = b;
      }
      __syncthreads();
      cta_bitonic_clean(acc, kp);
    }
  }

  for (int i = threadIdx.x; i < kout; i += blockDim.x) {
    word_t w = acc[i];
    out_k[row * kout + i] = unpack_key(w);
    out_v[row * kout + i] = unpack_tag(w);
  }
}

}  // namespace

extern "C" int topk_smallest_launch(const int* keys, const int* vals,
                                    int* out_k, int* out_v, int R, int N,
                                    int k, void* stream) {
  if (R <= 0 || N <= 0 || k <= 0) return (int)cudaErrorInvalidValue;
  const int kp = next_pow2(k);
  const int np = next_pow2(N) > kp ? next_pow2(N) : kp;
  if (kp > kChunk) return (int)cudaErrorInvalidValue;
  const int chunk = np < kChunk ? np : kChunk;
  const int n_chunks = np / chunk;
  const int kout = k < N ? k : N;
  const size_t smem = (size_t)(chunk + kp) * sizeof(word_t);
  cudaError_t err = allow_smem(topk_smallest_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  topk_smallest_kernel<<<R, threads_for(chunk), smem,
                         (cudaStream_t)stream>>>(keys, vals, out_k, out_v, N,
                                                 kp, kout, chunk, n_chunks);
  return (int)cudaGetLastError();
}

extern "C" const char* topk_smallest_error(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
