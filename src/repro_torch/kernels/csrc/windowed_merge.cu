// windowed_merge — the tiered insert's head merge, for Hopper (sm_90a).
//
// Replaces the Pallas kernel `windowed_merge_pallas`
// (src/repro/kernels/windowed_merge.py:52, body `_wmerge_kernel` :35) and
// the val/seq gather by tag that follows it (src/repro/kernels/ops.py:262-268).
// For every shard row it merges the ascending head (H) with the ascending
// incoming run (R) into the full ascending (H + R) window, lexicographic on
// (key, position tag): head tags are 0..H-1, run tags H..H+R-1, so ties put
// head before run, in position within each.  Val and seq follow their key by
// tag, and lanes whose key is the INF sentinel get val = seq = 0.
//
// What bounds it on the card: bytes.  Each row reads 3 (H + R) words and
// writes 3 (H + R) words (the registry's byte terms,
// src/repro/kernels/registry.py:436-440); the network does only
// (W/2) log2 W compare-exchanges on W = next_pow2(H + R) words, all in
// shared memory.
//
// Design: one thread block per row.  The row is loaded once into shared
// memory as packed (key, tag) words in the order head ++ reverse(run padded
// to W - H with (INF, tag) sentinels), which is a bitonic sequence, and one
// clean bitonic merge (log2 W stages) sorts it.  The epilogue unpacks each
// word and gathers val and seq from the head or the run by its tag, so the
// merge reads every input word once and writes every output word once.  A
// W of 8192 (the bulk prefill, H = 256 and R = 4096) needs 64 KB of shared
// memory, which the launch asks for as dynamic shared memory.

#include "bitonic.cuh"

using namespace repro_torch;

namespace {

constexpr int kMaxWindow = 16384;  // 128 KB of packed words per row

__global__ void windowed_merge_kernel(const int* __restrict__ head_k,
                                      const int* __restrict__ head_v,
                                      const int* __restrict__ head_q,
                                      const int* __restrict__ run_k,
                                      const int* __restrict__ run_v,
                                      const int* __restrict__ run_q,
                                      int* __restrict__ out_k,
                                      int* __restrict__ out_v,
                                      int* __restrict__ out_q, int H, int R,
                                      int Wp) {
  extern __shared__ word_t s[];
  const size_t row = blockIdx.x;
  const int W = H + R;
  const int* hk = head_k + row * H;
  const int* hv = head_v + row * H;
  const int* hq = head_q + row * H;
  const int* rk = run_k + row * R;
  const int* rv = run_v + row * R;
  const int* rq = run_q + row * R;

  for (int i = threadIdx.x; i < Wp; i += blockDim.x) {
    if (i < H) {
      s[i] = pack_kt(hk[i], i);
    } else {
      // slot i holds padded-run element r = Wp - 1 - i (the run reversed)
      int r = Wp - 1 - i;
      s[i] = pack_kt(r < R ? rk[r] : INT_MAX, H + r);
    }
  }
  __syncthreads();
  cta_bitonic_clean(s, Wp);

  int* ok = out_k + row * W;
  int* ov = out_v + row * W;
  int* oq = out_q + row * W;
  for (int i = threadIdx.x; i < W; i += blockDim.x) {
    word_t w = s[i];
    int key = unpack_key(w);
    int tag = unpack_tag(w);
    int v = 0, q = 0;
    if (key != INT_MAX) {
      if (tag < H) {
        v = hv[tag];
        q = hq[tag];
      } else {
        v = rv[tag - H];
        q = rq[tag - H];
      }
    }
    ok[i] = key;
    ov[i] = v;
    oq[i] = q;
  }
}

}  // namespace

extern "C" int windowed_merge_launch(const int* head_k, const int* head_v,
                                     const int* head_q, const int* run_k,
                                     const int* run_v, const int* run_q,
                                     int* out_k, int* out_v, int* out_q, int S,
                                     int H, int R, void* stream) {
  if (S <= 0 || H < 0 || R < 0 || H + R <= 0) return (int)cudaErrorInvalidValue;
  const int Wp = next_pow2(H + R);
  if (Wp > kMaxWindow) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)Wp * sizeof(word_t);
  cudaError_t err = allow_smem(windowed_merge_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  windowed_merge_kernel<<<S, threads_for(Wp), smem, (cudaStream_t)stream>>>(
      head_k, head_v, head_q, run_k, run_v, run_q, out_k, out_v, out_q, H, R,
      Wp);
  return (int)cudaGetLastError();
}

extern "C" const char* windowed_merge_error(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
