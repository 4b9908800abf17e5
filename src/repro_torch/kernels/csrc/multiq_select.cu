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
// compares.  What costs time is the chain of dependent steps in one block:
// a block-wide network would pay a barrier per stage (28 for a pairwise
// fold of 16 runs of 64 words in shared memory), each dearer than the work
// between them.  A rank select (each live word binary-searching every
// other run, one barrier) measured slower on the card at phase 2's inputs:
// its searches cost (live words) x S x log2 m shared-memory reads.
//
// Design: a warp-per-run fold.  Each window's take-prefix is already
// ascending, so nothing is sorted.  One block of min(S, 32) warps; warp s
// loads window s as a run of W = max(32, next_pow2(m)) packed (key, tag)
// words, every word outside the take-prefix and every pad column the
// largest word (INT32_MAX, INT32_MAX), so the run stays ascending, and
// fetches the popped words' vals into L1.  A warp with more windows
// (S > 32) loads each further one reversed, keeps the elementwise min and
// cleans it.  The runs live in registers for W <= 256 (`warp_bitonic.cuh`:
// strides of a lane's own words in the lane, the rest by
// `__shfl_xor_sync`) and in shared memory above; `block_fold` then folds
// the warps' runs pairwise, one `__syncthreads()` a level: 4 barriers at
// S = 16, where the block-wide fold took 28.  Warp 0 writes the first m
// words and gathers each val by its tag.  The windows are row-strided views
// of the (S, H) head tier, read in place with their row strides.

#include "warp_bitonic.cuh"

using namespace repro_torch;

namespace {

constexpr int kMaxRun = 16384;  // widest run: 128 KB of one warp's words

// The S windows.  A word's tag is s 2^lw + c (2^lw = W >= m): it orders
// like the position tag s m + c and splits without a division.
struct Windows {
  const int* win_k;
  int k_stride;
  const int* win_v;
  int v_stride;
  const int* take;
  int take_stride;
  int m;
  int lw;

  // Word c of window s: (key, tag) inside the take-prefix, else the pad.
  // A popped word's val is fetched into L1 here, for `emit`.
  __device__ __forceinline__ word_t word(int s, int c) const {
    if (c >= m) return kPadWord;
    const int t = take[(size_t)s * take_stride];
    const int key = win_k[(size_t)s * k_stride + c];
    if (c >= t) return kPadWord;
    asm volatile("prefetch.global.L1 [%0];" ::"l"(
        win_v + (size_t)s * v_stride + c));
    return pack_kt(key, (s << lw) + c);
  }

  // Output lane e of the winner w: its key, and its val gathered by tag
  // (0 on INF keys).
  __device__ __forceinline__ void emit(int* out_k, int* out_v, int e,
                                       word_t w) const {
    const int key = unpack_key(w);
    int v = 0;
    if (key != INT_MAX) {
      const int tag = unpack_tag(w);
      v = win_v[(size_t)(tag >> lw) * v_stride + (tag & ((1 << lw) - 1))];
    }
    out_k[e] = key;
    out_v[e] = v;
  }
};

// P > 0: runs of W = 32 P words in registers.  P == 0: runs of W words in
// shared memory (W > kRegRun).
template <int P>
__global__ void multiq_select_kernel(Windows win, int* __restrict__ out_k,
                                     int* __restrict__ out_v, int S, int W) {
  extern __shared__ word_t smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int warps = blockDim.x >> 5;

  if constexpr (P > 0) {
    constexpr int Wr = 32 * P;  // == W
    word_t acc[P];
#pragma unroll
    for (int r = 0; r < P; ++r) acc[r] = win.word(warp, lane * P + r);
    for (int s = warp + warps; s < S; s += warps) {
#pragma unroll
      for (int r = 0; r < P; ++r) {
        const word_t w = win.word(s, Wr - 1 - (lane * P + r));
        acc[r] = w < acc[r] ? w : acc[r];
      }
      warp_clean<P>(acc);
    }
    block_fold<P>(acc, smem);
    if (warp == 0) {
#pragma unroll
      for (int r = 0; r < P; ++r) {
        const int e = lane * P + r;
        if (e < win.m) win.emit(out_k, out_v, e, acc[r]);
      }
    }
  } else {
    word_t* acc = smem + (size_t)warp * W;
    for (int e = lane; e < W; e += 32) acc[e] = win.word(warp, e);
    for (int s = warp + warps; s < S; s += warps) {
      for (int e = lane; e < W; e += 32) {
        const word_t w = win.word(s, W - 1 - e);
        if (w < acc[e]) acc[e] = w;
      }
      __syncwarp();
      warp_smem_clean(acc, W);
    }
    block_fold_smem(smem, W, W);
    if (warp == 0) {
      for (int e = lane; e < win.m; e += 32) {
        win.emit(out_k, out_v, e, acc[e]);
      }
    }
  }
}

template <int P>
cudaError_t launch(const Windows& win, int* out_k, int* out_v, int S, int W,
                   int warps, size_t smem, cudaStream_t stream) {
  cudaError_t err = allow_smem(multiq_select_kernel<P>, smem);
  if (err != cudaSuccess) return err;
  multiq_select_kernel<P><<<1, warps * 32, smem, stream>>>(win, out_k, out_v,
                                                           S, W);
  return cudaGetLastError();
}

}  // namespace

extern "C" int multiq_select_launch(const int* win_k, int k_stride,
                                    const int* win_v, int v_stride,
                                    const int* take, int take_stride,
                                    int* out_k, int* out_v, int S, int m,
                                    void* stream) {
  if (S <= 0 || m <= 0 || m > kMaxRun) return (int)cudaErrorInvalidValue;
  const int mp = next_pow2(m);
  const int W = mp > 32 ? mp : 32;
  int lw = 0;
  while ((1 << lw) < W) ++lw;
  if (((long long)S << lw) > INT_MAX) return (int)cudaErrorInvalidValue;
  const Windows win{win_k, k_stride, win_v, v_stride,
                    take,  take_stride, m,     lw};
  int warps = S < kMaxWarps ? S : kMaxWarps;
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err;
  if (W <= kRegRun) {
    const size_t smem = (size_t)warps * W * sizeof(word_t);
    switch (W) {
      case 32:
        err = launch<1>(win, out_k, out_v, S, W, warps, smem, st);
        break;
      case 64:
        err = launch<2>(win, out_k, out_v, S, W, warps, smem, st);
        break;
      case 128:
        err = launch<4>(win, out_k, out_v, S, W, warps, smem, st);
        break;
      default:
        err = launch<8>(win, out_k, out_v, S, W, warps, smem, st);
        break;
    }
  } else {
    // one W-word run a warp
    const int fit = (int)(kWideSmem / (W * sizeof(word_t)));
    if (warps > fit) warps = fit;
    err = launch<0>(win, out_k, out_v, S, W, warps,
                    (size_t)warps * W * sizeof(word_t), st);
  }
  return (int)err;
}

extern "C" const char* multiq_select_error(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
