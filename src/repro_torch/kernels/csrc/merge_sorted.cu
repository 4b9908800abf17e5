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
// writes 2 C (src/repro/kernels/registry.py:443-446): 72 KB at the tuning
// shape (8, 1024, 128), about 0.04 µs of device memory.  What costs time
// is the chain of dependent steps: a bitonic clean of buffer ++ reversed
// run in one block would pay a barrier per stage (11 for the 2 C words of
// the tuning shape) and 16 C bytes of shared memory a row.
//
// Design: a rank merge, as in `windowed_merge.cu`, with ranks taken on the
// full (key, val) word (the key alone is not enough: vals are not
// positions).  Buffer word i goes to i + #{run words < w} and run word j
// to j + #{buffer words <= w}; these positions are a permutation of
// [0, C + R), and the words that land below C are the output, each slot
// written exactly once.  The run's pads are never materialised: a pad
// (INF, INT32_MAX) is >= every buffer word, so pad j would land at
// j + C >= C.  For the same reason a run word that equals the pad needs no
// search.  A run word with an INF key and a smaller val does: it may rank
// below INF-keyed buffer words with larger vals.
//
// Grid (S, ceil(C/256) + ceil(R/256)): a block owns a slice of 256 buffer
// words or 256 run words of one row, one word a thread (40 blocks at the
// tuning shape).  Each thread loads its own (key, val) while the block
// stages the OTHER row, packed into 64-bit words, in shared memory
// (16-byte loads of keys and vals where both rows are aligned, 4 of each
// in flight a thread); one `__syncthreads()`; then a binary search of
// log2 R (buffer word) or log2 C (run word) steps, and the thread writes
// its word where it lands below C.  Shared memory: 8 R bytes in a buffer
// block, 8 C in a run block, asked for above 48 KB only.  A row needs
// 8 C bytes where R > 0, so C <= 16384 on the H100 (227 KB a block); the
// launcher refuses what the card's opt-in limit cannot hold.

#include <climits>
#include <cstdint>

#include "bitonic.cuh"  // words, rank_in, allow_smem; it runs no network

using namespace repro_torch;

namespace {

constexpr int kThreads = 256;  // words per block slice
constexpr int kBatch = 4;      // 16-byte loads of keys (and of vals) in flight

// Pack n (key, val) pairs of global rows `keys`, `vals` into shared `dst`,
// 16 bytes of each a thread where both rows are 16-byte aligned; a thread
// issues kBatch loads of each before it stores any.
__device__ __forceinline__ void stage_words(word_t* __restrict__ dst,
                                            const int* __restrict__ keys,
                                            const int* __restrict__ vals,
                                            int n) {
  int done = 0;
  if (((reinterpret_cast<uintptr_t>(keys) |
        reinterpret_cast<uintptr_t>(vals)) & 15) == 0) {
    const int4* k4 = reinterpret_cast<const int4*>(keys);
    const int4* v4 = reinterpret_cast<const int4*>(vals);
    const int n4 = n >> 2;
    for (int base = threadIdx.x; base < n4; base += kBatch * blockDim.x) {
      int4 rk[kBatch], rv[kBatch];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int i = base + u * blockDim.x;
        if (i < n4) {
          rk[u] = k4[i];
          rv[u] = v4[i];
        }
      }
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int i = base + u * blockDim.x;
        if (i < n4) {
          ulonglong2* d = reinterpret_cast<ulonglong2*>(dst + 4 * i);
          d[0] = make_ulonglong2(pack_kt(rk[u].x, rv[u].x),
                                 pack_kt(rk[u].y, rv[u].y));
          d[1] = make_ulonglong2(pack_kt(rk[u].z, rv[u].z),
                                 pack_kt(rk[u].w, rv[u].w));
        }
      }
    }
    done = n & ~3;
  }
  for (int i = done + threadIdx.x; i < n; i += blockDim.x) {
    dst[i] = pack_kt(keys[i], vals[i]);
  }
}

__global__ void __launch_bounds__(kThreads)
    merge_sorted_kernel(const int* __restrict__ buf_k,
                        const int* __restrict__ buf_v,
                        const int* __restrict__ run_k,
                        const int* __restrict__ run_v,
                        int* __restrict__ out_k, int* __restrict__ out_v,
                        int C, int R, int buf_slices) {
  extern __shared__ ulonglong2 smem2[];
  word_t* other = reinterpret_cast<word_t*>(smem2);
  const size_t row = blockIdx.x;
  const bool is_buf = (int)blockIdx.y < buf_slices;
  const int slice = is_buf ? blockIdx.y : blockIdx.y - buf_slices;
  const int i = slice * kThreads + threadIdx.x;
  const int n_mine = is_buf ? C : R;
  const int n_other = is_buf ? R : C;
  const size_t mine_off = row * n_mine;
  const size_t other_off = row * n_other;

  // the thread's own word is in flight during the staging
  const bool live = i < n_mine;
  word_t w = kPadWord;
  if (live) {
    w = pack_kt((is_buf ? buf_k : run_k)[mine_off + i],
                (is_buf ? buf_v : run_v)[mine_off + i]);
  }
  stage_words(other, (is_buf ? run_k : buf_k) + other_off,
              (is_buf ? run_v : buf_v) + other_off, n_other);
  __syncthreads();
  if (!live) return;

  int at;
  if (is_buf) {
    at = i + rank_in(other, n_other, w, true);
  } else {
    if (w == kPadWord) return;  // lands at i + C
    at = i + rank_in(other, n_other, w, false);
  }
  if (at >= C) return;
  out_k[row * C + at] = unpack_key(w);
  out_v[row * C + at] = unpack_tag(w);
}

inline int slices(int n) { return (n + kThreads - 1) / kThreads; }

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
  // a buffer block stages the run, a run block (there is one where R > 0)
  // the buffer
  const size_t smem = (size_t)(R > 0 ? C : 0) * sizeof(word_t);
  if (smem > (size_t)optin) return (int)cudaErrorInvalidValue;
  err = allow_smem(merge_sorted_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(S, slices(C) + slices(R));
  merge_sorted_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      buf_k, buf_v, run_k, run_v, out_k, out_v, C, R, slices(C));
  return (int)cudaGetLastError();
}

extern "C" const char* merge_sorted_error(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
