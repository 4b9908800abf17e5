// merge_sorted — the capacity-wide sorted merge, for Hopper (sm_90a).
//
// Replaces the Pallas kernel `merge_sorted_pallas`
// (src/repro/kernels/sorted_merge.py:50, body `_merge_kernel` :32) and the
// run padding in front of it (src/repro/kernels/ops.py:292-308).  For every
// row it keeps the C smallest (key, val) pairs of an ascending buffer
// (S, C) and an ascending incoming run (S, R), R <= C, C a power of two,
// ascending and lexicographic on (key, val); the run is taken as padded to
// C with (INF, INT32_MAX), the largest word.  Vals are payloads, not unique
// tags, but two equal (key, val) words are the same bits, so the output is
// still exactly the plain version's.  No caller in the JAX package's core
// uses it (its insert path merges into the head tier, `windowed_merge`);
// the kernel completes the port's set.
//
// What bounds it on the card: bytes.  Each row reads 2 (C + R) words and
// writes 2 C (src/repro/kernels/registry.py:443-446); the network does
// C log2 (2 C) compare-exchanges per row in shared memory.
//
// Design: one thread block per row.  The row is loaded once into shared
// memory as packed (key, val) words in the order buffer ++ reverse(padded
// run) — a bitonic sequence — one clean bitonic merge (log2 2C stages)
// sorts it, and the first C words are written.  A row takes 16 C bytes of
// shared memory; a C whose row exceeds what one block can opt into
// (227 KB on the H100, so C <= 8192) is refused, not cut.

#include "bitonic.cuh"

using namespace repro_torch;

namespace {

__global__ void merge_sorted_kernel(const int* __restrict__ buf_k,
                                    const int* __restrict__ buf_v,
                                    const int* __restrict__ run_k,
                                    const int* __restrict__ run_v,
                                    int* __restrict__ out_k,
                                    int* __restrict__ out_v, int C, int R) {
  extern __shared__ word_t s[];
  const size_t row = blockIdx.x;
  const int* bk = buf_k + row * C;
  const int* bv = buf_v + row * C;
  const int* rk = run_k + row * R;
  const int* rv = run_v + row * R;
  for (int i = threadIdx.x; i < 2 * C; i += blockDim.x) {
    if (i < C) {
      s[i] = pack_kt(bk[i], bv[i]);
    } else {
      const int r = 2 * C - 1 - i;  // the padded run, reversed
      s[i] = r < R ? pack_kt(rk[r], rv[r]) : kPadWord;
    }
  }
  __syncthreads();
  cta_bitonic_clean(s, 2 * C);
  for (int i = threadIdx.x; i < C; i += blockDim.x) {
    const word_t w = s[i];
    out_k[row * C + i] = unpack_key(w);
    out_v[row * C + i] = unpack_tag(w);
  }
}

}  // namespace

extern "C" int merge_sorted_launch(const int* buf_k, const int* buf_v,
                                   const int* run_k, const int* run_v,
                                   int* out_k, int* out_v, int S, int C,
                                   int R, void* stream) {
  if (S <= 0 || C <= 0 || (C & (C - 1)) != 0 || R < 0 || R > C) {
    return (int)cudaErrorInvalidValue;
  }
  int device = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&optin,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               device);
  if (err != cudaSuccess) return (int)err;
  const size_t smem = (size_t)2 * C * sizeof(word_t);
  if (smem > (size_t)optin) return (int)cudaErrorInvalidValue;
  err = allow_smem(merge_sorted_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  merge_sorted_kernel<<<S, threads_for(2 * C), smem, (cudaStream_t)stream>>>(
      buf_k, buf_v, run_k, run_v, out_k, out_v, C, R);
  return (int)cudaGetLastError();
}

extern "C" const char* merge_sorted_error(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
