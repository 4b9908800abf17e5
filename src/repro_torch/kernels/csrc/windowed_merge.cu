// windowed_merge — the tiered insert's head merge, for Hopper (sm_90a).
//
// Replaces the Pallas kernel `windowed_merge_pallas`
// (src/repro/kernels/windowed_merge.py:52, body `_wmerge_kernel` :35) and
// the val/seq gather by tag that follows it (src/repro/kernels/ops.py:262-268).
// For every shard row it merges the ascending head (H) with the ascending
// incoming run (R) into the full ascending (H + R) window, lexicographic on
// (key, position): a head word comes before a run word with an equal key,
// and within each row words keep their positions.  Val and seq follow
// their key, and lanes whose key is the INF sentinel get val = seq = 0.
//
// What bounds it on the card: bytes.  Each row reads its H + R keys and
// the val and seq of its live words, and writes 3 (H + R) words (the
// registry's byte terms, src/repro/kernels/registry.py:436-440, less the
// payloads of INF words): at most 7.7 KB a row at the step shape
// (H, R) = (256, 64), well under a microsecond of device memory.  What
// costs time is the chain of dependent steps, so the design keeps that
// chain to one round trip to memory before the barrier, the barrier, and
// one binary search, which the val and seq loads overlap.
//
// Design: a rank merge, the JAX package's `rank` arm
// (src/repro/core/pqueue/local.py:86-138) as a scatter.  Head word i goes
// to i + #{run keys < head_k[i]} and run word j to
// j + #{head keys <= run_k[j]}; these positions are a permutation of
// [0, H + R), so every output word is written exactly once and nothing is
// sorted or padded.  Grid (S, ceil(H/256) + ceil(R/256)): a block owns a
// slice of 256 head words or 256 run words of one row, one word a thread.
// Each thread loads its own key, while the block stages the keys of the
// OTHER row in shared memory (16-byte loads where the row is aligned, 4 in
// flight a thread, so the prefill's 16 KB run is one round trip to
// memory); a thread whose key is live (not INF) then loads its val and seq;
// one `__syncthreads()`; then each thread binary-searches its key's rank
// there (log2 R steps for a head word, log2 H for a run word) and writes
// key, val and seq at its position.  A run word whose key is INF needs no
// search: every head key is <= INF, so it lands at H + j with val = seq =
// 0.  That takes the prefill's pads (a shard gets about 256 of the 4096
// keys) out of the work, and the kernel reads no val or seq that the
// output does not hold: it moves the bytes its bound counts.  Loading val
// and seq with the key, for every word, measured 2 % slower at the step
// and 1 % at the prefill (PERF.md, section 6).
//
// Blocks: 32 at the step shapes (16, 256, 64), (16, 256, 57) and
// (16, 256, 22), 272 at the prefill (16, 256, 4096); one barrier.  The
// bitonic clean this replaced ran 16 blocks and 9 (step) or 13 (prefill)
// barriers on rows padded to 512 or 8192 words.  Shared memory: the row a
// block searches, R words
// (16 KB at the prefill) when there are head words, H when there are run
// words; asked for above 48 KB only.

#include <climits>
#include <cstdint>

#include "bitonic.cuh"  // rank_in, allow_smem; this kernel runs no network

using namespace repro_torch;

namespace {

constexpr int kThreads = 256;        // words per block slice
constexpr int kMaxWindow = 1 << 15;  // H + R; the staged row <= 128 KB
constexpr int kBatch = 4;            // 16-byte loads a thread has in flight

// Copy n ints of global row `src` into shared `dst`, 16 bytes a thread
// where `src` is 16-byte aligned.  A thread issues kBatch loads before it
// stores any, so a long row costs one round trip to memory per kBatch
// loads a thread, not one per load.
__device__ __forceinline__ void stage_row(int* __restrict__ dst,
                                          const int* __restrict__ src,
                                          int n) {
  int done = 0;
  if ((reinterpret_cast<uintptr_t>(src) & 15) == 0) {
    const int4* s4 = reinterpret_cast<const int4*>(src);
    int4* d4 = reinterpret_cast<int4*>(dst);
    const int n4 = n >> 2;
    for (int base = threadIdx.x; base < n4; base += kBatch * blockDim.x) {
      int4 r[kBatch];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int i = base + u * blockDim.x;
        if (i < n4) r[u] = s4[i];
      }
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int i = base + u * blockDim.x;
        if (i < n4) d4[i] = r[u];
      }
    }
    done = n & ~3;
  }
  for (int i = done + threadIdx.x; i < n; i += blockDim.x) dst[i] = src[i];
}

__global__ void __launch_bounds__(kThreads)
    windowed_merge_kernel(const int* __restrict__ head_k,
                          const int* __restrict__ head_v,
                          const int* __restrict__ head_q,
                          const int* __restrict__ run_k,
                          const int* __restrict__ run_v,
                          const int* __restrict__ run_q,
                          int* __restrict__ out_k, int* __restrict__ out_v,
                          int* __restrict__ out_q, int H, int R,
                          int head_slices) {
  extern __shared__ int4 smem4[];
  int* other = reinterpret_cast<int*>(smem4);
  const size_t row = blockIdx.x;
  const bool is_head = (int)blockIdx.y < head_slices;
  const int slice = is_head ? blockIdx.y : blockIdx.y - head_slices;
  const int i = slice * kThreads + threadIdx.x;
  const int n_mine = is_head ? H : R;
  const int n_other = is_head ? R : H;
  const size_t mine_off = row * (is_head ? H : R);
  const int* mk = (is_head ? head_k : run_k) + mine_off;
  const int* mv = (is_head ? head_v : run_v) + mine_off;
  const int* mq = (is_head ? head_q : run_q) + mine_off;

  // the thread's own key is in flight during the staging; its val and
  // seq are read only where the key is live
  const bool live = i < n_mine;
  const int key = live ? mk[i] : INT_MAX;
  stage_row(other, is_head ? run_k + row * R : head_k + row * H, n_other);
  int v = 0, q = 0;
  if (key != INT_MAX) {
    v = mv[i];
    q = mq[i];
  }
  __syncthreads();
  if (!live) return;

  int rank;
  if (is_head) {
    rank = rank_in(other, n_other, key, true);
  } else {
    rank = key == INT_MAX ? H : rank_in(other, n_other, key, false);
  }
  const size_t at = row * (size_t)(H + R) + i + rank;
  out_k[at] = key;
  out_v[at] = v;
  out_q[at] = q;
}

inline int slices(int n) { return (n + kThreads - 1) / kThreads; }

}  // namespace

extern "C" int windowed_merge_launch(const int* head_k, const int* head_v,
                                     const int* head_q, const int* run_k,
                                     const int* run_v, const int* run_q,
                                     int* out_k, int* out_v, int* out_q, int S,
                                     int H, int R, void* stream) {
  if (S <= 0 || H < 0 || R < 0 || H + R <= 0 || H + R > kMaxWindow)
    return (int)cudaErrorInvalidValue;
  const int staged_for_head = H > 0 ? R : 0, staged_for_run = R > 0 ? H : 0;
  const size_t smem =
      (size_t)(staged_for_head > staged_for_run ? staged_for_head
                                                : staged_for_run) *
      sizeof(int);
  cudaError_t err = allow_smem(windowed_merge_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(S, slices(H) + slices(R));
  windowed_merge_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      head_k, head_v, head_q, run_k, run_v, run_q, out_k, out_v, out_q, H, R,
      slices(H));
  return (int)cudaGetLastError();
}

extern "C" const char* windowed_merge_error(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
