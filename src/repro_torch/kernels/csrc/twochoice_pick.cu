// twochoice_pick — the MULTIQ two-choice probe, for Hopper (sm_90a).
//
// Replaces the Pallas kernel `twochoice_pick_pallas`
// (src/repro/kernels/twochoice.py:67, body `_twochoice_kernel` :39).  Each
// of m deleter lanes holds two sampled shard ids in [0, S); it reads the
// two shards' cached minima, commits to the shard whose minimum is smaller
// (a tie goes to the lower id), and the kernel counts the lanes committed
// to each shard.  An id outside [0, S) reads INT_MAX and is never counted.
// Inactive lanes (act == 0) are counted nowhere.  `act` is a bool mask,
// one byte per lane, as the MULTIQ core builds it.  The output is (S,)
// int32.
//
// What bounds it on the card: neither bytes nor operations.  It reads S
// minima, m mask bytes and two ids per active lane, and writes S counts:
// well under a microsecond of either; the launch costs more than the work.
//
// Design, for S <= 32 (every main-path shape): one warp, everything in
// registers.  Lane s holds mins[s]; each lane takes deleter lanes l,
// l + 32, ..., reads its two minima from lanes a and b with `__shfl_sync`,
// and commits.  The counts are bit-sliced ballots: one `__ballot_sync` of
// "committed" and one per bit of the chosen shard id (5, unrolled), so lane
// s finds the lanes committed to it as the AND of the bit masks that spell
// s, and adds their `__popc`.  No barrier, no shared memory, no atomics;
// lanes s < S write counts[s].  Each 32 deleter lanes cost one dependent
// round trip to memory, so at m = 128 the warp is slower than the block
// body below would be (PERF.md, section 6); the main path's m is B <= 64.
// For S > 32 the launch takes a second kernel, the block body of the
// first port: one thread per deleter lane, the minima copied into shared
// memory, the counts a shared-memory histogram of atomic adds, written out
// once.
// The inputs are 1-D and may be strided: `mins` is the column
// `head_keys[:, 0]` of the tiered state, read in place with its element
// stride.

#include "warp_bitonic.cuh"  // allow_smem, kFullMask

using namespace repro_torch;

namespace {

constexpr int kWarpShards = 32;  // shards one warp holds in registers

__device__ __forceinline__ bool in_range(int id, int S) {
  return id >= 0 && id < S;
}

// the shard a lane commits to: a tie goes to the lower id
__device__ __forceinline__ int pick(int a, int b, int min_a, int min_b) {
  return (min_a < min_b) || (min_a == min_b && a <= b) ? a : b;
}

// S <= 32: one warp, minima and counts in registers.
__global__ void twochoice_warp_kernel(const int* __restrict__ mins,
                                      int mins_stride,
                                      const int* __restrict__ choice_a,
                                      int a_stride,
                                      const int* __restrict__ choice_b,
                                      int b_stride,
                                      const unsigned char* __restrict__ act,
                                      int act_stride, int* __restrict__ counts,
                                      int S, int m) {
  const int lane = threadIdx.x;
  const int my_min = lane < S ? mins[(size_t)lane * mins_stride] : INT_MAX;
  int count = 0;
  for (int base = 0; base < m; base += 32) {
    const int l = base + lane;
    bool active = false;
    int a = -1, b = -1;
    if (l < m) {
      active = act[(size_t)l * act_stride] != 0;
      a = choice_a[(size_t)l * a_stride];
      b = choice_b[(size_t)l * b_stride];
    }
    const bool in_a = in_range(a, S), in_b = in_range(b, S);
    const int got_a = __shfl_sync(kFullMask, my_min, in_a ? a : 0);
    const int got_b = __shfl_sync(kFullMask, my_min, in_b ? b : 0);
    const int chosen =
        pick(a, b, in_a ? got_a : INT_MAX, in_b ? got_b : INT_MAX);
    const bool committed = active && in_range(chosen, S);
    // the lanes committed to shard `lane`: chosen's 5 bits spell `lane`
    unsigned to_me = __ballot_sync(kFullMask, committed);
#pragma unroll
    for (int k = 0; k < 5; ++k) {
      const unsigned set = __ballot_sync(kFullMask, (chosen >> k) & 1);
      to_me &= ((lane >> k) & 1) ? set : ~set;
    }
    count += __popc(to_me);
  }
  if (lane < S) counts[lane] = count;
}

// S > 32: the first port's block body, one thread per deleter lane.
__global__ void twochoice_block_kernel(const int* __restrict__ mins,
                                       int mins_stride,
                                       const int* __restrict__ choice_a,
                                       int a_stride,
                                       const int* __restrict__ choice_b,
                                       int b_stride,
                                       const unsigned char* __restrict__ act,
                                       int act_stride,
                                       int* __restrict__ counts, int S,
                                       int m) {
  extern __shared__ int sm[];
  int* smin = sm;      // S cached minima
  int* cnt = sm + S;   // S commit counts
  for (int i = threadIdx.x; i < S; i += blockDim.x) {
    smin[i] = mins[(size_t)i * mins_stride];
    cnt[i] = 0;
  }
  __syncthreads();
  for (int l = threadIdx.x; l < m; l += blockDim.x) {
    if (act[(size_t)l * act_stride] == 0) continue;
    const int a = choice_a[(size_t)l * a_stride];
    const int b = choice_b[(size_t)l * b_stride];
    // an id outside [0, S) reads INT_MAX, as the Pallas kernel's one-hot
    // masks do, and is never counted
    const int min_a = (a >= 0 && a < S) ? smin[a] : INT_MAX;
    const int min_b = (b >= 0 && b < S) ? smin[b] : INT_MAX;
    const bool pick_a = (min_a < min_b) || (min_a == min_b && a <= b);
    const int chosen = pick_a ? a : b;
    if (chosen >= 0 && chosen < S) atomicAdd(&cnt[chosen], 1);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < S; i += blockDim.x) counts[i] = cnt[i];
}

}  // namespace

extern "C" int twochoice_pick_launch(const int* mins, int mins_stride,
                                     const int* choice_a, int a_stride,
                                     const int* choice_b, int b_stride,
                                     const unsigned char* act, int act_stride,
                                     int* counts, int S, int m, void* stream) {
  if (S <= 0 || m < 0) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  if (S <= kWarpShards) {
    twochoice_warp_kernel<<<1, 32, 0, st>>>(mins, mins_stride, choice_a,
                                            a_stride, choice_b, b_stride, act,
                                            act_stride, counts, S, m);
    return (int)cudaGetLastError();
  }
  const size_t smem = (size_t)2 * S * sizeof(int);
  cudaError_t err = allow_smem(twochoice_block_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  const int threads = m < 32 ? 32 : (m > 1024 ? 1024 : m);
  twochoice_block_kernel<<<1, threads, smem, st>>>(
      mins, mins_stride, choice_a, a_stride, choice_b, b_stride, act,
      act_stride, counts, S, m);
  return (int)cudaGetLastError();
}

extern "C" const char* twochoice_pick_error(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
