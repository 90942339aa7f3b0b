// One stable LSD digit pass of the (col, row) radix planner: B1 + B2.
//
// Replaces repro/kernels/radix_sort/radix_sort.py:
//   digit_block_histogram (_digit_hist_kernel)       -> digit_histogram_kernel
//   digit_placement (_digit_placement_kernel), fused
//   with the payload scatter of radix_sort/ops.py     -> digit_placement_kernel
//
// What bounds it on the H100: bytes.  A pass reads the keys twice (once
// per kernel, 4L B each), the payload once (4L B) and writes the new
// permutation once (4L B); the per-block histogram is nbins * nblocks
// int32, under 1% of that.  The work per key is a shift, a mask and one
// shared-memory counter update, far below the card's integer rate.
//
// What the simple design does about it: each block takes a tile of
// TILE = 4096 keys (256 threads x 16), so every key is read with
// neighbouring threads on neighbouring addresses and the histogram stays
// in shared memory.  The histogram is written digit-major
// (hist[d * nblocks + b]) so one exclusive scan over the flat array
// (outside, in PyTorch) yields every (digit, block) base.  Placement
// re-reads the tile in input order: each warp owns a contiguous 512-key
// sub-range, counts its digits, a scan across the 8 warps turns the
// counts into per-warp bases, and then 32 keys at a time
// __match_any_sync + __popc(peers & lanemask_lt) rank each key among
// the earlier equal digits.  That order (warp, step, lane) is input
// order, which is what makes the pass stable.  The landing position
// never reaches device memory: the payload is scattered straight to it.
// Nothing is tuned; wgmma/TMA do not apply to a counting pass.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kPerThread = 16;
constexpr int kTile = kThreads * kPerThread;  // keys per block
constexpr int kWarpSpan = kTile / kWarps;     // contiguous keys per warp
constexpr int kMaxBins = 256;                 // digits of at most 8 bits

__device__ __forceinline__ int digit_of(const int32_t* __restrict__ keys,
                                        long long i, long long L, int shift,
                                        int mask, int nbins) {
  if (i >= L) return -1;  // ragged tail, masked by index
  int d = (__ldg(keys + i) >> shift) & mask;
  return d < nbins ? d : -1;  // out-of-contract keys are never placed
}

__global__ void __launch_bounds__(kThreads)
digit_histogram_kernel(const int32_t* __restrict__ keys,
                       int32_t* __restrict__ hist, long long L, int shift,
                       int mask, int nbins, int nblocks) {
  __shared__ int counts[kMaxBins];
  for (int d = threadIdx.x; d < nbins; d += kThreads) counts[d] = 0;
  __syncthreads();
  const long long tile0 = (long long)blockIdx.x * kTile;
#pragma unroll
  for (int k = 0; k < kPerThread; ++k) {
    int d = digit_of(keys, tile0 + k * kThreads + threadIdx.x, L, shift,
                     mask, nbins);
    if (d >= 0) atomicAdd(&counts[d], 1);
  }
  __syncthreads();
  for (int d = threadIdx.x; d < nbins; d += kThreads)
    hist[(long long)d * nblocks + blockIdx.x] = counts[d];
}

__global__ void __launch_bounds__(kThreads)
digit_placement_kernel(const int32_t* __restrict__ keys,
                       const int32_t* __restrict__ base,
                       const int32_t* __restrict__ payload,
                       int32_t* __restrict__ out, long long L, int shift,
                       int mask, int nbins, int nblocks) {
  __shared__ int cnt[kWarps][kMaxBins];
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const unsigned lanemask_lt = (1u << lane) - 1u;
  for (int k = threadIdx.x; k < kWarps * kMaxBins; k += kThreads)
    cnt[k / kMaxBins][k % kMaxBins] = 0;
  __syncthreads();
  const long long w0 = (long long)blockIdx.x * kTile + warp * kWarpSpan;

  // 1. digit counts of this warp's contiguous sub-range
  for (int s = 0; s < kWarpSpan; s += 32) {
    int d = digit_of(keys, w0 + s + lane, L, shift, mask, nbins);
    unsigned peers = __match_any_sync(0xffffffffu, d);
    if (d >= 0 && lane == __ffs(peers) - 1) cnt[warp][d] += __popc(peers);
    __syncwarp();
  }
  __syncthreads();

  // 2. exclusive scan across warps, seeded with the (digit, block) base
  for (int d = threadIdx.x; d < nbins; d += kThreads) {
    int run = base[(long long)d * nblocks + blockIdx.x];
    for (int w = 0; w < kWarps; ++w) {
      int c = cnt[w][d];
      cnt[w][d] = run;
      run += c;
    }
  }
  __syncthreads();

  // 3. rank among earlier equal digits, in input order, and scatter
  for (int s = 0; s < kWarpSpan; s += 32) {
    const long long i = w0 + s + lane;
    int d = digit_of(keys, i, L, shift, mask, nbins);
    unsigned peers = __match_any_sync(0xffffffffu, d);
    int p = 0;
    if (d >= 0) p = cnt[warp][d] + __popc(peers & lanemask_lt);
    __syncwarp();
    if (d >= 0) {
      if (lane == __ffs(peers) - 1) cnt[warp][d] += __popc(peers);
      out[p] = payload ? payload[i] : (int32_t)i;
    }
    __syncwarp();
  }
}

}  // namespace

extern "C" int digit_histogram_launch(const void* keys, void* hist,
                                      long long L, int shift, int bits,
                                      int nbins, int nblocks,
                                      void* stream) {
  digit_histogram_kernel<<<nblocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const int32_t*)keys, (int32_t*)hist, L, shift, (1 << bits) - 1, nbins,
      nblocks);
  return (int)cudaGetLastError();
}

extern "C" int digit_placement_launch(const void* keys, const void* base,
                                      const void* payload, void* out,
                                      long long L, int shift,
                                      int bits, int nbins, int nblocks,
                                      void* stream) {
  digit_placement_kernel<<<nblocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const int32_t*)keys, (const int32_t*)base, (const int32_t*)payload,
      (int32_t*)out, L, shift, (1 << bits) - 1, nbins,
      nblocks);
  return (int)cudaGetLastError();
}

extern "C" int radix_tile(void) { return kTile; }
extern "C" int radix_max_bins(void) { return kMaxBins; }
