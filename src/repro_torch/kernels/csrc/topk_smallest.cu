// topk_smallest — the deleteMin tournament, for Hopper (sm_90a).
//
// Replaces the Pallas kernel `topk_smallest_pallas`
// (src/repro/kernels/bitonic_topk.py:128, body `_topk_kernel` :110).  For
// every row of an (R, N) batch it returns the k lexicographically smallest
// (key, val) pairs, ascending; callers pass unique position tags as vals.
// Words past N are (INT32_MAX, INT32_MAX) pads, which sort behind every
// real pair (INF keys included), so min(k, N) columns are written and none
// of them is a pad.  k' = next_pow2(k) is at most 4096.
//
// What bounds it on the card: neither bytes nor operations.  Each row reads
// 2 N words and writes 2 k words (src/repro/kernels/registry.py:412-415),
// about 11 KB at the SPRAY tournament's (1, 1424, 64), a few nanoseconds of
// device memory.  What costs time is the chain of dependent network stages
// on one SM: a block-wide network would pay a barrier per stage (66 for a
// full sort of 2048 words), while the main path gives the kernel one to four
// rows, so all but a few SMs idle whatever the network does.
//
// Design: the Pallas kernel's chunked fold (sort a k'-chunk, fold chunks by
// `bitonic_merge_topk`) mapped onto warps, so that the sorts need no block
// barrier.  One block per row, up to 32 warps; a warp owns chunks of
// W = max(64, k') words (ceil(N / W) chunks a row, one warp a chunk where
// there are at most 32).  A warp loads its chunk, packs (key, val) into
// 64-bit words and bitonic-sorts it inside the warp (`warp_bitonic.cuh`):
// in registers for W <= 256 (at most 8 words a lane; strides of a lane's
// own words stay in the lane, the rest go through `__shfl_xor_sync`), in
// shared memory with `__syncwarp()` between stages for 512 <= W <= 4096.  A
// warp with more chunks sorts each further chunk descending, keeps the
// elementwise min against its run (a bitonic sequence holding the W
// smallest of both) and cleans it.  The warps' runs then fold pairwise in
// ceil(log2 warps) levels, one `__syncthreads()` each: the upper warp of a
// pair leaves its run in shared memory, the lower warp takes the min
// against it reversed and cleans.  At (1, 1424, 64) that is 23 warps and 5
// barriers, where one block-wide sort of the padded row took 66.  Warp 0
// writes the first min(k, N) words.

#include "warp_bitonic.cuh"

using namespace repro_torch;

namespace {

constexpr int kMaxRun = 4096;  // widest k'

// Chunk words [base, base + 32 P) of a row into a register run, lane l
// holding words l P .. l P + P - 1; pads past N.
template <int P>
__device__ __forceinline__ void load_run(word_t (&v)[P], const int* rk,
                                         const int* rv, int N, int base) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int r = 0; r < P; ++r) {
    const int g = base + lane * P + r;
    v[r] = g < N ? pack_kt(rk[g], rv[g]) : kPadWord;
  }
}

// P > 0: runs of W = 32 P words in registers.  P == 0: runs of W words in
// shared memory (W > kRegRun).
template <int P>
__global__ void topk_smallest_kernel(const int* __restrict__ keys,
                                     const int* __restrict__ vals,
                                     int* __restrict__ out_k,
                                     int* __restrict__ out_v, int N, int W,
                                     int kout, int n_chunks) {
  extern __shared__ word_t smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int warps = blockDim.x >> 5;
  const size_t row = blockIdx.x;
  const int* rk = keys + row * N;
  const int* rv = vals + row * N;
  int* ok = out_k + row * kout;
  int* ov = out_v + row * kout;

  if constexpr (P > 0) {
    constexpr int Wr = 32 * P;  // == W
    word_t acc[P];
    load_run<P>(acc, rk, rv, N, warp * Wr);
    warp_sort<P>(acc, false);
    for (int c = warp + warps; c < n_chunks; c += warps) {
      word_t v[P];
      load_run<P>(v, rk, rv, N, c * Wr);
      warp_sort<P>(v, true);
#pragma unroll
      for (int r = 0; r < P; ++r) acc[r] = v[r] < acc[r] ? v[r] : acc[r];
      warp_clean<P>(acc);
    }
    block_fold<P>(acc, smem);
    if (warp == 0) {
#pragma unroll
      for (int r = 0; r < P; ++r) {
        const int e = lane * P + r;
        if (e < kout) {
          ok[e] = unpack_key(acc[r]);
          ov[e] = unpack_tag(acc[r]);
        }
      }
    }
  } else {
    word_t* acc = smem + (size_t)warp * 2 * W;
    word_t* buf = acc + W;
    for (int c = warp; c < n_chunks; c += warps) {
      const bool first = c == warp;
      word_t* dst = first ? acc : buf;
      for (int e = lane; e < W; e += 32) {
        const int g = c * W + e;
        dst[e] = g < N ? pack_kt(rk[g], rv[g]) : kPadWord;
      }
      __syncwarp();
      warp_smem_sort(dst, W, !first);
      if (!first) {
        for (int e = lane; e < W; e += 32) {
          if (buf[e] < acc[e]) acc[e] = buf[e];
        }
        __syncwarp();
        warp_smem_clean(acc, W);
      }
    }
    block_fold_smem(smem, 2 * (size_t)W, W);
    if (warp == 0) {
      for (int e = lane; e < kout; e += 32) {
        ok[e] = unpack_key(acc[e]);
        ov[e] = unpack_tag(acc[e]);
      }
    }
  }
}

template <int P>
cudaError_t launch(const int* keys, const int* vals, int* out_k, int* out_v,
                   int R, int N, int W, int kout, int n_chunks, int warps,
                   size_t smem, cudaStream_t stream) {
  cudaError_t err = allow_smem(topk_smallest_kernel<P>, smem);
  if (err != cudaSuccess) return err;
  topk_smallest_kernel<P><<<R, warps * 32, smem, stream>>>(
      keys, vals, out_k, out_v, N, W, kout, n_chunks);
  return cudaGetLastError();
}

}  // namespace

extern "C" int topk_smallest_launch(const int* keys, const int* vals,
                                    int* out_k, int* out_v, int R, int N,
                                    int k, void* stream) {
  if (R <= 0 || N <= 0 || k <= 0 || k > kMaxRun) {
    return (int)cudaErrorInvalidValue;
  }
  const int kp = next_pow2(k);
  const int W = kp > 64 ? kp : 64;
  const int n_chunks = (N - 1) / W + 1;
  const int kout = k < N ? k : N;
  int warps = n_chunks < kMaxWarps ? n_chunks : kMaxWarps;
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err;
  if (W <= kRegRun) {
    const size_t smem = (size_t)warps * W * sizeof(word_t);
    switch (W) {
      case 64:
        err = launch<2>(keys, vals, out_k, out_v, R, N, W, kout, n_chunks,
                        warps, smem, st);
        break;
      case 128:
        err = launch<4>(keys, vals, out_k, out_v, R, N, W, kout, n_chunks,
                        warps, smem, st);
        break;
      default:
        err = launch<8>(keys, vals, out_k, out_v, R, N, W, kout, n_chunks,
                        warps, smem, st);
        break;
    }
  } else {
    // 2 W words a warp: its run and a chunk
    const int fit = (int)(kWideSmem / (2 * W * sizeof(word_t)));
    if (warps > fit) warps = fit;
    const size_t smem = (size_t)warps * 2 * W * sizeof(word_t);
    err = launch<0>(keys, vals, out_k, out_v, R, N, W, kout, n_chunks, warps,
                    smem, st);
  }
  return (int)err;
}

extern "C" const char* topk_smallest_error(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
