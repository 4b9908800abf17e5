// multiq_select — the MULTIQ commit-side tournament, for Hopper (sm_90a).
//
// Replaces the Pallas kernel `multiq_select_pallas`
// (src/repro/kernels/twochoice.py:122, body `_multiq_select_kernel` :96),
// with the padding in front of it and the payload gather after it
// (src/repro/kernels/ops.py:180-197).  Shard s's committed lanes pop the
// first take[s] words of its ascending head window win_k[s, :m]; the kernel
// returns the m smallest popped (key, val) pairs, ascending and
// lexicographic on (key, tag) with tags s * m + column, and gathers each
// val by its tag.  Lanes past the popped count, and popped INF keys, read
// (INF, 0).
//
// What bounds it on the card: neither bytes nor operations.  It must read
// the S takes, the popped keys (at most S m words) and the vals of the m
// winners only, and write 2 m words: at most 4.4 KB at the main path's
// (S, m) = (16, 57), under 2 ns of device memory, and S m log2 m
// compares; a launch costs more than the work.
//
// Design: one block for the whole batch.  The S windows are loaded once
// into shared memory as S' = next_pow2(S) runs of m' = next_pow2(m) packed
// (key, tag) words each, with every word outside a take-prefix, every pad
// column (m is 57 on the paper's Fig. 11 trace) and every pad row set to
// the largest word (INT32_MAX, INT32_MAX), as the JAX wrapper pads.  Each
// run is then ascending, so no run is sorted: `cta_fold_topk_runs` folds
// the S' runs pairwise in log2 S' levels (the Pallas kernel folds them one
// after the other, S - 1 merges) and run 0 holds the answer.  The windows
// are row-strided views of the (S, H) head tier, read in place with their
// row strides.

#include "bitonic.cuh"

using namespace repro_torch;

namespace {

constexpr int kMaxWords = 16384;  // 128 KB of packed words

__global__ void multiq_select_kernel(const int* __restrict__ win_k,
                                     int k_stride,
                                     const int* __restrict__ win_v,
                                     int v_stride,
                                     const int* __restrict__ take,
                                     int take_stride, int* __restrict__ out_k,
                                     int* __restrict__ out_v, int S, int m,
                                     int Sp, int mp) {
  extern __shared__ word_t s[];
  for (int i = threadIdx.x; i < Sp * mp; i += blockDim.x) {
    const int r = i / mp, c = i % mp;
    word_t w = kPadWord;
    if (r < S && c < m && c < take[(size_t)r * take_stride]) {
      w = pack_kt(win_k[(size_t)r * k_stride + c], r * m + c);
    }
    s[i] = w;
  }
  __syncthreads();
  cta_fold_topk_runs(s, Sp, mp);
  for (int i = threadIdx.x; i < m; i += blockDim.x) {
    const word_t w = s[i];
    const int key = unpack_key(w);
    int v = 0;
    if (key != INT_MAX) {
      const int tag = unpack_tag(w);
      v = win_v[(size_t)(tag / m) * v_stride + tag % m];
    }
    out_k[i] = key;
    out_v[i] = v;
  }
}

}  // namespace

extern "C" int multiq_select_launch(const int* win_k, int k_stride,
                                    const int* win_v, int v_stride,
                                    const int* take, int take_stride,
                                    int* out_k, int* out_v, int S, int m,
                                    void* stream) {
  if (S <= 0 || m <= 0) return (int)cudaErrorInvalidValue;
  const int Sp = next_pow2(S), mp = next_pow2(m);
  if ((long long)Sp * mp > kMaxWords) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)Sp * mp * sizeof(word_t);
  cudaError_t err = allow_smem(multiq_select_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  multiq_select_kernel<<<1, threads_for(Sp * mp), smem,
                         (cudaStream_t)stream>>>(win_k, k_stride, win_v,
                                                 v_stride, take, take_stride,
                                                 out_k, out_v, S, m, Sp, mp);
  return (int)cudaGetLastError();
}

extern "C" const char* multiq_select_error(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
