// Timing probes of B1 (csrc/radix_sort.cu), for comparison only: nothing
// in the port calls them.  chip_smoke.py and kernel_times.py time them
// beside the kernel on the radix chain's passes and the skewed streams.
//
//  - The design B1 replaced (the first port): one block of 256 threads a
//    tile, 16 scalar bounds-checked loads a thread, one shared histogram
//    a block, its flush one counter a 32 B sector.
//  - The counter schemes that lost, on B1's runs, loads and flush: per
//    tile, counters in two sets by tile parity, summed at the tile's end
//    into a staged chunk of 16 tiles (a __syncthreads and a copy a
//    tile); per-warp counters or one set a block; a shared atomic a key
//    or __match_any_sync aggregation (one atomic per distinct digit of a
//    warp's keys).
//  - The loads alone: B1's walk over its run and its 16 B loads with the
//    counting removed, a floor for any design that reads the keys so.
//  - B1 itself at any run length (tiles a block), with chunks of 8 or 32
//    tiles, and without its flush.
#include "radix_sort.cu"

namespace {

__device__ __forceinline__ int digit_of(const int32_t* __restrict__ keys,
                                        long long i, long long L, int shift,
                                        int mask, int nbins) {
  if (i >= L) return -1;  // ragged tail, masked by index
  int d = (__ldg(keys + i) >> shift) & mask;
  return d < nbins ? d : -1;  // out-of-contract keys are never placed
}

// The replaced design, as it shipped.
__global__ void __launch_bounds__(kThreads)
replaced_histogram_kernel(const int32_t* __restrict__ keys,
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

constexpr int kSchemeChunk = 16;  // the schemes' staged tiles

// One key into the counters: into its digit's (a digit >= nbins has a
// counter too, which nothing reads), a key past the tile's end into
// counter kMaxBins.  kMatch: the warp's lanes with equal counters add
// once, their number (every lane must reach it).
template <bool kMatch>
__device__ __forceinline__ void count_key(int* cnt, int key, int j,
                                          int tile_n, int shift, int mask) {
  const int d = j < tile_n ? (key >> shift) & mask : kMaxBins;
  if (kMatch) {
    const unsigned peers = __match_any_sync(0xffffffffu, d);
    if ((int)(threadIdx.x & 31) == __ffs(peers) - 1)
      atomicAdd(cnt + d, __popc(peers));
  } else {
    atomicAdd(cnt + d, 1);
  }
}

// B1's runs, loads and flush with another counter scheme.  kPrivate:
// each warp counts into its own counters (else one set a block); kMatch:
// see count_key.
template <bool kPrivate, bool kMatch>
__global__ void __launch_bounds__(kThreads, kHistPerSm)
scheme_histogram_kernel(const int32_t* __restrict__ keys,
                        int32_t* __restrict__ hist, long long L, int shift,
                        int mask, int nbins, int nblocks, int run, int vec) {
  constexpr int kCopies = kPrivate ? kWarps : 1;
  // counters by tile parity: tile g counts into cnt[g & 1] while the
  // other set, read at tile g - 1's end, is zero again
  __shared__ int cnt[2][kCopies][kMaxBins + 1];
  __shared__ int staged[kMaxBins][kSchemeChunk + 1];
  const int t = threadIdx.x;
  const int first = blockIdx.x * run;
  const int ntiles = min(run, nblocks - first);
  const bool v = vec != 0;
  int4 cur[kHistLoads], nxt[kHistLoads];
  load_tile(cur, keys, (long long)first * kTile, L, v);
  for (int k = t; k < 2 * kCopies * (kMaxBins + 1); k += kThreads)
    (&cnt[0][0][0])[k] = 0;
  __syncthreads();
  for (int g = 0; g < ntiles; ++g) {
    const long long tile0 = (long long)(first + g) * kTile;
    if (g + 1 < ntiles) load_tile(nxt, keys, tile0 + kTile, L, v);
    int* c = &cnt[g & 1][kPrivate ? t / 32 : 0][0];
    const long long left = L - tile0;
    const int tile_n = left < kTile ? (int)left : kTile;
#pragma unroll
    for (int k = 0; k < kHistLoads; ++k) {
      const int j = 4 * (k * kThreads + t);
      count_key<kMatch>(c, cur[k].x, j, tile_n, shift, mask);
      count_key<kMatch>(c, cur[k].y, j + 1, tile_n, shift, mask);
      count_key<kMatch>(c, cur[k].z, j + 2, tile_n, shift, mask);
      count_key<kMatch>(c, cur[k].w, j + 3, tile_n, shift, mask);
    }
    __syncthreads();
    // thread d: the tile's count of digit d into the chunk, and its
    // counters zeroed for tile g + 2
    const int kc = g % kSchemeChunk;
    if (t < nbins) {
      int sum = 0;
#pragma unroll
      for (int w = 0; w < kCopies; ++w) {
        sum += cnt[g & 1][w][t];
        cnt[g & 1][w][t] = 0;
      }
      staged[t][kc] = sum;
    }
    if (kc == kSchemeChunk - 1 || g == ntiles - 1) {
      __syncthreads();
      const int n = kc + 1;
      const long long at = first + g - kc;
      for (int q = t; q < nbins * n; q += kThreads) {
        const int d = q / n;
        const int cc = q - d * n;
        hist[(long long)d * nblocks + at + cc] = staged[d][cc];
      }
      // the next writes to staged[][] come after tile g + 1's barrier
    }
#pragma unroll
    for (int k = 0; k < kHistLoads; ++k) cur[k] = nxt[k];
  }
}

// B1's loads alone: the same run, loads and prefetch; the keys are folded
// into one word that is written only if it takes a value no run gives
// in practice (so the loads are not removed).
__global__ void __launch_bounds__(kThreads, kHistPerSm)
load_floor_kernel(const int32_t* __restrict__ keys,
                  int32_t* __restrict__ out, long long L, int nblocks,
                  int run, int vec) {
  const int first = blockIdx.x * run;
  const int ntiles = min(run, nblocks - first);
  const bool v = vec != 0;
  int4 cur[kHistLoads], nxt[kHistLoads];
  load_tile(cur, keys, (long long)first * kTile, L, v);
  int acc = 0;
  for (int g = 0; g < ntiles; ++g) {
    if (g + 1 < ntiles)
      load_tile(nxt, keys, (long long)(first + g + 1) * kTile, L, v);
#pragma unroll
    for (int k = 0; k < kHistLoads; ++k)
      acc += cur[k].x ^ cur[k].y ^ cur[k].z ^ cur[k].w;
#pragma unroll
    for (int k = 0; k < kHistLoads; ++k) cur[k] = nxt[k];
  }
  if (acc == 0x5bd1e995) out[blockIdx.x] = acc;
}

}  // namespace

// variant: 0 the replaced design; 1 B1 as shipped; the schemes: 2
// per-warp counters, an atomic a key; 3 one set a block,
// __match_any_sync; 4 per-warp counters, __match_any_sync; 5 one set a
// block, an atomic a key; 6 the loads alone (hist[0..grid) is scratch,
// not a histogram); 7 and 8 B1 with chunks of 8 and of 32 tiles; 9 B1
// without its flush (hist is scratch).  run: tiles a block for 1-9 (<= 0:
// hist_run's).
extern "C" int probe_digit_histogram_launch(int variant, const void* keys,
                                            void* hist, long long L,
                                            int shift, int bits, int nbins,
                                            int nblocks, int run,
                                            void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (run <= 0) {
    int sms = 0;
    const int rc = device_sms(&sms);
    if (rc) return rc;
    run = hist_run(nblocks, sms);
  }
  switch (variant) {
    case 0:
      replaced_histogram_kernel<<<nblocks, kThreads, 0, s>>>(
          (const int32_t*)keys, (int32_t*)hist, L, shift, (1 << bits) - 1,
          nbins, nblocks);
      return (int)cudaGetLastError();
    case 1:
      return launch_histogram(digit_histogram_kernel<kHistChunk>, keys, hist,
                              L, shift, bits, nbins, nblocks, run, s);
    case 2:
      return launch_histogram(scheme_histogram_kernel<true, false>, keys,
                              hist, L, shift, bits, nbins, nblocks, run, s);
    case 3:
      return launch_histogram(scheme_histogram_kernel<false, true>, keys,
                              hist, L, shift, bits, nbins, nblocks, run, s);
    case 4:
      return launch_histogram(scheme_histogram_kernel<true, true>, keys,
                              hist, L, shift, bits, nbins, nblocks, run, s);
    case 5:
      return launch_histogram(scheme_histogram_kernel<false, false>, keys,
                              hist, L, shift, bits, nbins, nblocks, run, s);
    case 6: {
      const int grid = (nblocks + run - 1) / run;
      load_floor_kernel<<<grid, kThreads, 0, s>>>(
          (const int32_t*)keys, (int32_t*)hist, L, nblocks, run,
          (int)((uintptr_t)keys % 16 == 0));
      return (int)cudaGetLastError();
    }
    case 7:
      return launch_histogram(digit_histogram_kernel<8>, keys, hist, L,
                              shift, bits, nbins, nblocks, run, s);
    case 8:
      return launch_histogram(digit_histogram_kernel<32>, keys, hist, L,
                              shift, bits, nbins, nblocks, run, s);
    case 9:
      return launch_histogram(digit_histogram_kernel<kHistChunk, false>,
                              keys, hist, L, shift, bits, nbins, nblocks,
                              run, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
