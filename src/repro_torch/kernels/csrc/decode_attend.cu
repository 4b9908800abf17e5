// decode_attend — one-token decode attention over a per-row-length cache,
// for Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package's attention is plain `jnp`
// (src/repro/models/layers/attention.py) and has no Pallas kernel.  It was
// added because the plain arm of `attend_chunked`, run on the card, cast
// every 2,048-position chunk of the whole cache to f32 and copied it into
// `einsum`'s layout for rows whose valid prefix is a few percent of the
// cache: about 95 % of a granite-8b decode step's device time at 64 slots
// and 4,096 positions (PERF.md, section 5).
//
// What it computes, for row b, query head h and its KV head h / G, over the
// positions p < kv_len[b] (clamped to [0, S]), all in f32:
//   q' = float(round_T(q[b, h] * scale))      (`scale` already rounded to T)
//   s_p = q' . float(k[b, p, h / G])
//   out[b, h] = round_T(sum_p exp(s_p - m) float(v[b, p, h / G])
//                       / max(sum_p exp(s_p - m), 1e-30)),  m = max_p s_p
// T is bf16 or f32, the type of q, k, v and out.  This is the plain arm's
// arithmetic (`_scaled_f32` and the chunked branch): the query is scaled in
// T, then f32; K and V are widened to f32 in registers; scores,
// probabilities, their sums and P.V stay f32 (no bf16 or TF32 product
// anywhere).  Positions at or past kv_len[b] are never read: the plain arm
// gives their scores -1e30, whose exp is exactly 0, so leaving them out
// changes only the order of the sums.  A row with kv_len 0 reads 0.
//
// What bounds it: bytes, K and V of the valid prefix read once (q and out
// are 1/(2 kv_len) of that).  At the serving shapes that prefix is small
// (granite-8b, 64 rows with contexts near 60: about 16 MB a call, 5 us at
// 3.35 TB/s), so the kernel is bound by memory latency and by the launch.
//
// Design.  The grid is fixed by the shapes alone: a block for each split
// of kSplit positions, KV head (and group of its query heads) and row, so
// the lengths are read on the device, never by the host, and the call can
// be captured in a CUDA graph.  A block whose split starts at or past its
// row's length exits at once (a row of length 0 still writes its 0 through
// split 0), and a 4,096-position row spreads over four SMs a KV head.  A
// block serves up to 8 query heads of its KV head (G = 1..8: all of them;
// G = 9..16: two head groups) from every K/V chunk it loads.
//   Inside a block of 128 threads, ch lanes (hd / 8 rounded up to a power
// of two) hold one position's row of K: 8 elements a lane, one 16-byte
// load in bf16 (two in f32), neighbouring lanes on neighbouring addresses
// and neighbouring lane groups on neighbouring positions.  A lane group
// loads NPL positions' K and V at once, so a batch (128 / ch lane groups x
// NPL positions) costs one round trip to memory; each K and V chunk is
// widened once for all the heads.  The group sums q'.k over its lanes with
// `__shfl_xor_sync` and keeps an online softmax (running max, sum and its
// 8 dims of acc) for each head.  At the end the groups of a warp merge by
// shuffles and the four warps through shared memory.  A row of one live
// split writes its output there; otherwise each split writes (acc, m, l)
// to the wrapper's scratch, and a second launch, one thread an output
// element, merges a row's splits in order.  Every sum runs in a fixed
// order, so the result does not change from run to run.

#include <cuda_bf16.h>

#include <cmath>
#include <cstdint>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxHeadDim = 256;
constexpr int kMaxGroup = 16;         // query heads a KV head may serve
constexpr int kMaxHeadsPerBlock = 8;  // query heads a block serves
constexpr int kSplit = 1024;          // positions a block takes
constexpr int kMaxGridDim = 65535;    // gridDim.y and gridDim.z
constexpr int kCombineThreads = 256;
constexpr unsigned kFull = 0xFFFFFFFFu;

// Eight consecutive elements of a q, K or V row, as loaded.
template <typename T>
struct Chunk;

template <>
struct Chunk<__nv_bfloat16> {
  uint4 w;
  __device__ __forceinline__ void load(const __nv_bfloat16* p) {
    w = __ldg(reinterpret_cast<const uint4*>(p));
  }
  __device__ __forceinline__ void clear() { w = make_uint4(0, 0, 0, 0); }
  // bf16 -> f32 is exact: the 16 bits become the high half of the word
  __device__ __forceinline__ static void pair(unsigned u, float& lo,
                                              float& hi) {
    lo = __uint_as_float(u << 16);
    hi = __uint_as_float(u & 0xFFFF0000u);
  }
  __device__ __forceinline__ void widen(float (&f)[8]) const {
    pair(w.x, f[0], f[1]);
    pair(w.y, f[2], f[3]);
    pair(w.z, f[4], f[5]);
    pair(w.w, f[6], f[7]);
  }
};

template <>
struct Chunk<float> {
  float4 a, b;
  __device__ __forceinline__ void load(const float* p) {
    const float4* p4 = reinterpret_cast<const float4*>(p);
    a = __ldg(p4);
    b = __ldg(p4 + 1);
  }
  __device__ __forceinline__ void clear() {
    a = make_float4(0.f, 0.f, 0.f, 0.f);
    b = a;
  }
  __device__ __forceinline__ void widen(float (&f)[8]) const {
    f[0] = a.x; f[1] = a.y; f[2] = a.z; f[3] = a.w;
    f[4] = b.x; f[5] = b.y; f[6] = b.z; f[7] = b.w;
  }
};

// Positions a lane group loads at once: 32 bytes of K and 32 of V a lane,
// halved for 8 heads a block (their scores and acc take the registers).
template <typename T, int HB>
__host__ __device__ constexpr int positions_per_group() {
  return (sizeof(T) == 2 ? 4 : 2) / (HB > 4 ? 2 : 1);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}
template <>
__device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f32(float x) { return x; }

// The live splits of a row: those that start below its length (clamped
// to [0, S]), at least 1 (a row of length 0 still writes its 0).
__device__ __forceinline__ int live_splits(int len, int S) {
  len = len < 0 ? 0 : (len > S ? S : len);
  return len <= kSplit ? 1 : (len + kSplit - 1) / kSplit;
}

// exp(m - to), 0 for a state that has seen no position (m = -inf)
__device__ __forceinline__ float rescale(float m, float to) {
  return m > -INFINITY ? expf(m - to) : 0.f;
}

// Dynamic shared memory of the warp merge: acc, m and l of each warp for
// each head.
__host__ __device__ constexpr size_t merge_smem(int hb, int hd) {
  return sizeof(float) * (size_t)kWarps * hb * (hd + 2);
}

__host__ __device__ __forceinline__ int splits_of(int S) {
  return (S + kSplit - 1) / kSplit;
}

// Grid (splits_of(S), Hkv * n_hg, B): split blockIdx.x of row blockIdx.z
// for the KV head and head group blockIdx.y.
template <typename T, int HB>
__global__ void __launch_bounds__(kThreads)
    decode_attend_kernel(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v,
                         const int* __restrict__ kv_len, T* __restrict__ out,
                         float* __restrict__ part, float scale, int S,
                         int Hkv, int G, int hd, int ch, int n_hg) {
  constexpr int NPL = positions_per_group<T, HB>();
  extern __shared__ __align__(16) float red[];  // merge_smem(HB, hd)
  __shared__ float blk_m[HB], blk_l[HB];        // the block's max and sum
  const int split = blockIdx.x, b = blockIdx.z;
  const int len = min(max(kv_len[b], 0), S);
  const int n_live = live_splits(len, S);
  if (split >= n_live) return;  // past the row's length
  const int p_begin = split * kSplit, p_end = min(p_begin + kSplit, len);

  const int nrg = kThreads / ch;  // lane groups
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int c = threadIdx.x & (ch - 1);  // the lane's 8-element chunk
  const int rg = threadIdx.x / ch;       // its lane group
  const bool has_chunk = c * 8 < hd;
  const int Hq = Hkv * G;
  const int kvh = blockIdx.y / n_hg, hg = blockIdx.y % n_hg;
  const int h0 = kvh * G + hg * HB;  // the block's first query head
  const int nh = min(HB, G - hg * HB);
  const size_t pos_stride = (size_t)Hkv * hd;
  const size_t at = ((size_t)b * S * Hkv + kvh) * hd + c * 8;

  // q' = float(round_T(q * scale)), this lane's chunk of each head
  float qf[HB][8];
#pragma unroll
  for (int g = 0; g < HB; ++g) {
    Chunk<T> qc;
    if (has_chunk && g < nh)
      qc.load(q + ((size_t)b * Hq + h0 + g) * hd + c * 8);
    else
      qc.clear();
    qc.widen(qf[g]);
#pragma unroll
    for (int e = 0; e < 8; ++e)
      qf[g][e] = to_f32(from_f32<T>(qf[g][e] * scale));
  }
  float m[HB], l[HB], acc[HB][8];
#pragma unroll
  for (int g = 0; g < HB; ++g) {
    m[g] = -INFINITY;
    l[g] = 0.f;
#pragma unroll
    for (int e = 0; e < 8; ++e) acc[g][e] = 0.f;
  }

  // every lane runs every batch: the shuffles below take the whole warp
  for (int base = p_begin; base < p_end; base += nrg * NPL) {
    const int p0 = base + rg;
    Chunk<T> kc[NPL], vc[NPL];
#pragma unroll
    for (int j = 0; j < NPL; ++j) {
      const int p = p0 + j * nrg;
      if (has_chunk && p < p_end) {
        kc[j].load(k + at + p * pos_stride);
        vc[j].load(v + at + p * pos_stride);
      } else {
        kc[j].clear();
        vc[j].clear();
      }
    }
    float s[HB][NPL];
#pragma unroll
    for (int j = 0; j < NPL; ++j) {
      float kf[8];
      kc[j].widen(kf);
#pragma unroll
      for (int g = 0; g < HB; ++g) {
        float a = 0.f;
#pragma unroll
        for (int e = 0; e < 8; ++e) a = fmaf(qf[g][e], kf[e], a);
        s[g][j] = a;
      }
    }
    for (int off = ch >> 1; off > 0; off >>= 1) {
#pragma unroll
      for (int g = 0; g < HB; ++g)
#pragma unroll
        for (int j = 0; j < NPL; ++j)
          s[g][j] += __shfl_xor_sync(kFull, s[g][j], off);
    }
#pragma unroll
    for (int g = 0; g < HB; ++g) {
      float bm = -INFINITY;
#pragma unroll
      for (int j = 0; j < NPL; ++j)
        if (p0 + j * nrg < p_end) bm = fmaxf(bm, s[g][j]);
      if (bm > m[g]) {
        const float corr = rescale(m[g], bm);
        l[g] *= corr;
#pragma unroll
        for (int e = 0; e < 8; ++e) acc[g][e] *= corr;
        m[g] = bm;
      }
    }
#pragma unroll
    for (int j = 0; j < NPL; ++j) {
      if (p0 + j * nrg < p_end) {
        float vf[8];
        vc[j].widen(vf);
#pragma unroll
        for (int g = 0; g < HB; ++g) {
          const float pj = expf(s[g][j] - m[g]);
          l[g] += pj;
#pragma unroll
          for (int e = 0; e < 8; ++e) acc[g][e] = fmaf(pj, vf[e], acc[g][e]);
        }
      }
    }
  }

  // merge the lane groups of each warp: lanes c, c + ch, ... hold chunk c
#pragma unroll
  for (int g = 0; g < HB; ++g) {
    for (int off = ch; off < 32; off <<= 1) {
      const float mo = __shfl_xor_sync(kFull, m[g], off);
      const float lo = __shfl_xor_sync(kFull, l[g], off);
      const float mn = fmaxf(m[g], mo);
      const float fa = rescale(m[g], mn), fb = rescale(mo, mn);
      l[g] = l[g] * fa + lo * fb;
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const float xo = __shfl_xor_sync(kFull, acc[g][e], off);
        acc[g][e] = acc[g][e] * fa + xo * fb;
      }
      m[g] = mn;
    }
  }
  // merge the warps, and write the output or the split's part
  float* red_acc = red;                   // [warp][head][hd]
  float* red_m = red + kWarps * HB * hd;  // [warp][head]
  float* red_l = red_m + kWarps * HB;
  if (lane < ch && has_chunk) {
#pragma unroll
    for (int g = 0; g < HB; ++g)
#pragma unroll
      for (int e = 0; e < 8; ++e)
        red_acc[(warp * HB + g) * hd + c * 8 + e] = acc[g][e];
  }
  if (lane == 0) {
#pragma unroll
    for (int g = 0; g < HB; ++g) {
      red_m[warp * HB + g] = m[g];
      red_l[warp * HB + g] = l[g];
    }
  }
  __syncthreads();
  // each warp's factor for each head, exp(m_w - M), in place of its max
  if (threadIdx.x < HB) {
    const int g = threadIdx.x;
    float M = -INFINITY, L = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) M = fmaxf(M, red_m[w * HB + g]);
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float f = rescale(red_m[w * HB + g], M);
      red_m[w * HB + g] = f;
      L += red_l[w * HB + g] * f;
    }
    blk_m[g] = M;
    blk_l[g] = L;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < nh * hd; i += kThreads) {
    const int g = i / hd, d = i % hd;
    float A = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w)
      A += red_acc[(w * HB + g) * hd + d] * red_m[w * HB + g];
    const size_t row = (size_t)b * Hq + h0 + g;
    if (n_live == 1) {
      out[row * hd + d] = from_f32<T>(A / fmaxf(blk_l[g], 1e-30f));
    } else {
      float* pp = part + (row * gridDim.x + split) * (hd + 2);
      pp[d] = A;
      if (d == 0) {
        pp[hd] = blk_m[g];
        pp[hd + 1] = blk_l[g];
      }
    }
  }
}

// Merge the live splits of each row that has more than one, in split
// order: one thread an output element, grid (ceil(Hq hd /
// kCombineThreads), B).
template <typename T>
__global__ void __launch_bounds__(kCombineThreads)
    decode_attend_combine(const int* __restrict__ kv_len,
                          const float* __restrict__ part, T* __restrict__ out,
                          int S, int Hq, int hd) {
  const int b = blockIdx.y;
  const int i = blockIdx.x * kCombineThreads + threadIdx.x;
  const int n_live = live_splits(kv_len[b], S);
  if (n_live <= 1 || i >= Hq * hd) return;
  const int h = i / hd, d = i % hd;
  const size_t row = (size_t)b * Hq + h;
  const float* pp = part + row * splits_of(S) * (hd + 2);
  float M = -INFINITY;
  for (int j = 0; j < n_live; ++j) M = fmaxf(M, pp[j * (hd + 2) + hd]);
  float A = 0.f, L = 0.f;
  for (int j = 0; j < n_live; ++j) {
    const float f = rescale(pp[j * (hd + 2) + hd], M);
    L += pp[j * (hd + 2) + hd + 1] * f;
    A += pp[j * (hd + 2) + d] * f;
  }
  out[row * hd + d] = from_f32<T>(A / fmaxf(L, 1e-30f));
}

template <typename T, int HB>
cudaError_t launch_hb(const T* q, const T* k, const T* v, const int* kv_len,
                      T* out, float* part, float scale, int B, int S,
                      int Hkv, int G, int hd, int ch, cudaStream_t st) {
  const int n_hg = (G + HB - 1) / HB;
  const dim3 grid(splits_of(S), Hkv * n_hg, B);
  decode_attend_kernel<T, HB><<<grid, kThreads, merge_smem(HB, hd), st>>>(
      q, k, v, kv_len, out, part, scale, S, Hkv, G, hd, ch, n_hg);
  cudaError_t err = cudaGetLastError();
  // one split a row at most: nothing to merge
  if (err != cudaSuccess || S <= kSplit) return err;
  const int Hq = Hkv * G;
  const dim3 cgrid((Hq * hd + kCombineThreads - 1) / kCombineThreads, B);
  decode_attend_combine<T><<<cgrid, kCombineThreads, 0, st>>>(
      kv_len, part, out, S, Hq, hd);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_typed(const void* q, const void* k, const void* v,
                         const int* kv_len, void* out, float* part,
                         float scale, int B, int S, int Hq, int Hkv, int hd,
                         cudaStream_t st) {
  const int G = Hq / Hkv;
  int ch = 1;
  while (ch * 8 < hd) ch <<= 1;
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  T* ot = static_cast<T*>(out);
  if (G <= 1)
    return launch_hb<T, 1>(qt, kt, vt, kv_len, ot, part, scale, B, S, Hkv,
                           G, hd, ch, st);
  if (G <= 2)
    return launch_hb<T, 2>(qt, kt, vt, kv_len, ot, part, scale, B, S, Hkv,
                           G, hd, ch, st);
  if (G <= 4)
    return launch_hb<T, 4>(qt, kt, vt, kv_len, ot, part, scale, B, S, Hkv,
                           G, hd, ch, st);
  return launch_hb<T, kMaxHeadsPerBlock>(qt, kt, vt, kv_len, ot, part, scale,
                                         B, S, Hkv, G, hd, ch, st);
}

}  // namespace

// The floats of scratch a call at these shapes needs (B * Hq * the splits
// of S * (hd + 2)), or -1 where the kernel does not take them: B and Hkv
// 1 to 65,535 (with Hkv * ceil(G / 8) in that range), S at least 1, Hq a
// multiple of Hkv with G = Hq / Hkv up to 16, hd a multiple of 8 up to
// 256.  This is the one place that holds these limits.
extern "C" long long decode_attend_scratch(int B, int S, int Hq, int Hkv,
                                           int hd) {
  if (B <= 0 || B > kMaxGridDim || S <= 0 || Hkv <= 0 || Hq <= 0 ||
      Hq % Hkv != 0 || Hq / Hkv > kMaxGroup || hd <= 0 || hd % 8 != 0 ||
      hd > kMaxHeadDim ||
      (long long)Hkv * ((Hq / Hkv + kMaxHeadsPerBlock - 1) /
                        kMaxHeadsPerBlock) > kMaxGridDim)
    return -1;
  return (long long)B * Hq * splits_of(S) * (hd + 2);
}

// q, out (B, 1, Hq, hd) and k, v (B, S, Hkv, hd), contiguous, all of one
// type (`dtype` 0: bf16, 1: f32), 16-byte aligned; kv_len (B,) int32;
// `part` holds decode_attend_scratch(B, S, Hq, Hkv, hd) floats; `scale` is
// already rounded to the type.
extern "C" int decode_attend_launch(const void* q, const void* k,
                                    const void* v, const int* kv_len,
                                    void* out, float* part, float scale,
                                    int dtype, int B, int S, int Hq, int Hkv,
                                    int hd, void* stream) {
  if (decode_attend_scratch(B, S, Hq, Hkv, hd) < 0)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0)
    return (int)launch_typed<__nv_bfloat16>(q, k, v, kv_len, out, part, scale,
                                            B, S, Hq, Hkv, hd, st);
  if (dtype == 1)
    return (int)launch_typed<float>(q, k, v, kv_len, out, part, scale, B, S,
                                    Hq, Hkv, hd, st);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* decode_attend_error(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
