// twochoice_pick — the MULTIQ two-choice probe, for Hopper (sm_90a).
//
// Replaces the Pallas kernel `twochoice_pick_pallas`
// (src/repro/kernels/twochoice.py:67, body `_twochoice_kernel` :39).  Each
// of m deleter lanes holds two sampled shard ids in [0, S); it reads the
// two shards' cached minima, commits to the shard whose minimum is smaller
// (a tie goes to the lower id), and the kernel counts the lanes committed
// to each shard.  Inactive lanes (act == 0) are parked out of range and
// counted nowhere.  `act` is a bool mask, one byte per lane, as the MULTIQ
// core builds it.  The output is (S,) int32.
//
// What bounds it on the card: neither bytes nor operations.  It reads S
// minima, m mask bytes and two ids per active lane, and writes S counts:
// well under a microsecond of either; a launch costs more than the work.
//
// Design: one block, one thread per lane.  The Pallas kernel avoids
// gathers (one-hot (m, S) masks, since Mosaic cannot lower an int gather);
// here the block copies `mins` into shared memory, each lane gathers its two
// minima from there, and the counts are a shared-memory histogram built with
// atomic adds, written out once.  The inputs are 1-D and may be strided:
// `mins` is the column `head_keys[:, 0]` of the tiered state, passed
// without a copy with its element stride.

#include "bitonic.cuh"

using namespace repro_torch;

namespace {

__global__ void twochoice_pick_kernel(const int* __restrict__ mins,
                                      int mins_stride,
                                      const int* __restrict__ choice_a,
                                      int a_stride,
                                      const int* __restrict__ choice_b,
                                      int b_stride,
                                      const unsigned char* __restrict__ act,
                                      int act_stride, int* __restrict__ counts,
                                      int S, int m) {
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
  const size_t smem = (size_t)2 * S * sizeof(int);
  cudaError_t err = allow_smem(twochoice_pick_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  int threads = m < 32 ? 32 : (m > 1024 ? 1024 : m);
  twochoice_pick_kernel<<<1, threads, smem, (cudaStream_t)stream>>>(
      mins, mins_stride, choice_a, a_stride, choice_b, b_stride, act,
      act_stride, counts, S, m);
  return (int)cudaGetLastError();
}

extern "C" const char* twochoice_pick_error(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
