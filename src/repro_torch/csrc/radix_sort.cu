// One stable LSD digit pass of the (col, row) radix planner: B1 + B2.
//
// Replaces repro/kernels/radix_sort/radix_sort.py:
//   digit_block_histogram (_digit_hist_kernel)       -> digit_histogram_kernel
//   digit_placement (_digit_placement_kernel), fused
//   with the payload scatter of radix_sort/ops.py     -> digit_placement_kernel
//
// What bounds it on the H100: bytes.  B1 reads the pass's key word once
// (4L B) and writes nbins * nblocks int32 counters (a sixteenth of that
// at 256 bins).
// B2 reads the key word, the payload and the carried words once and
// writes the payload and the carried words once: 12-24 B a key, 108L B
// over the six passes of the 5e7 set.  The work per key is a shift, a
// mask and a few shared-memory operations, far below the integer rate.
//
// B1 writes one histogram a tile of TILE = 4096 keys, digit-major
// (hist[d * nblocks + b]), so one exclusive scan over the flat array
// (outside, in PyTorch) yields every (digit, tile) base.  Its bound is
// 4L + 4 nbins nblocks bytes.  What held the first port (one block a
// tile: 0.116 ms at 5e7, 8.1 us at 2.5e6, 53% and 39% of that bound)
// back, and what the design does about each:
//   1. one short block a tile (611 blocks at L = 2.5e6, 12,208 at 5e7):
//      a block walks a contiguous run of G tiles, G = ceil(nblocks /
//      (SMs x kHistPerSm)), so the grid is at most one resident wave and
//      every SM holds blocks (hist_run; the SM count is read once);
//   2. 16 scalar bounds-checked loads a thread: 4 x 16 B loads through
//      the read-only path, unchecked for a whole aligned tile (scalar
//      ones where the keys are not 16 B aligned, and at the ragged end),
//      the next tile's in flight while the current one is counted;
//   3. the counting's instructions, not contention, were what cost at
//      2.5e6: Hopper's shared atomics add a warp's equal addresses in
//      one step, so one histogram a block is as fast as per-warp
//      counters even with every key equal, and __match_any_sync
//      aggregation costs 1.5-5x.  A key is a shift, a mask, an address
//      and an atomic: a digit >= nbins counts in its own row, which no
//      flush reads, a key past the end (the last tile only) in row
//      kMaxBins, so there is no compare and no branch a key.  The block
//      counts straight into the tile's column of the chunk: no barrier
//      and no copy a tile;
//   4. a flush that put each counter in its own 32 B sector: a chunk of
//      up to kHistChunk tiles is written with neighbouring lanes on
//      neighbouring tiles of one digit (64 B a digit at 5e7, 8 B at
//      2.5e6, where G = 2).
// At 5e7 it reaches 86% of the bound, its loads alone 93%; at 2.5e6
// 60-63%, its loads alone 85%: there the launch and one L2 round trip
// are most of the time.  The probes (csrc/radix_sort_probe.cu) hold the
// replaced design, the counter schemes that lost, chunks of 8 and 32
// tiles, any run length, B1 without its flush and the loads alone.
//
// B2 is Onesweep's local sort of one tile (without its fused histogram):
//   1. every word of the tile is copied once into shared memory in input
//      order with cp.async, as 16 B vectors where the words are 16 B
//      aligned: the key word first, then the payload and up to two carried
//      words, whose copies are still in flight while the keys are ranked;
//   2. each warp ranks 32 keys a round in input order (warp, round, lane):
//      ballots on the digit's bits give each key its peers, and
//      __popc(peers & lanemask_lt) plus the warp's running count of the
//      digit its rank, which is what makes the pass stable;
//   3. a block-wide scan of the digit totals gives each digit's start in
//      the tile and each warp's start inside it;
//   4. the tile's stable digit order is written to shared memory as the
//      tile position of each key (2 B) and its digit (1 B);
//   5. payload and carried words are written out in that order, so
//      neighbouring threads write neighbouring addresses inside each
//      digit's run (32 keys, 128 B, on average at 7-bit digits) instead of
//      one 32-byte sector a key.
// The carried words are what the next passes read: a row pass carries
// the rows (its own key) and the cols, a column pass the cols, so the
// chain needs no gather of the next key through the permutation.  Keys
// past L or with a digit >= nbins are never placed.  What is left is
// the scattered runs of step 5: written to the tile's own positions
// instead, the same pass took 0.46 of its 0.69 ms (H100, 5e7 set).
// wgmma/TMA do not apply to a counting pass.
#include <cstdint>
#include <cuda_runtime.h>
#include "resources.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kPerThread = 16;
constexpr int kTile = kThreads * kPerThread;  // keys per block
constexpr int kWarpSpan = kTile / kWarps;     // contiguous keys per warp
constexpr int kMaxBins = 256;                 // digits of at most 8 bits
constexpr int kMaxCarry = 2;                  // words carried beside the payload
constexpr int kHistPerSm = 4;    // B1 blocks resident an SM: its grid's wave
constexpr int kHistChunk = 16;   // B1 tiles counted between two flushes
constexpr int kHistLoads = kPerThread / 4;  // B1's 16 B loads a thread a tile

// Tiles a B1 block walks: the fewest that keep the grid within one
// resident wave of kHistPerSm blocks an SM (kernels/radix_sort/ref.py
// hist_runs is the same rule).
__host__ __device__ inline int hist_run(int nblocks, int sms) {
  const long long wave = (long long)sms * kHistPerSm;
  return (int)((nblocks + wave - 1) / wave);
}

// Keys [i, i + 4) of the stream: one 16 B load where the keys are 16 B
// aligned and all four lie before L; else scalar loads, 0 past L (the
// count masks those by index).
__device__ __forceinline__ int4 load4(const int32_t* __restrict__ keys,
                                      long long i, long long L, bool vec) {
  if (vec && i + 4 <= L) return __ldg(reinterpret_cast<const int4*>(keys + i));
  int4 v;
  v.x = i < L ? __ldg(keys + i) : 0;
  v.y = i + 1 < L ? __ldg(keys + i + 1) : 0;
  v.z = i + 2 < L ? __ldg(keys + i + 2) : 0;
  v.w = i + 3 < L ? __ldg(keys + i + 3) : 0;
  return v;
}

// A tile's keys for this thread: load k holds keys tile0 + 4 (k kThreads
// + t) .. + 3, so each load of the block reads 4 KB contiguously.  A
// whole aligned tile takes 16 B loads without a check.
__device__ __forceinline__ void load_tile(int4 (&v)[kHistLoads],
                                          const int32_t* __restrict__ keys,
                                          long long tile0, long long L,
                                          bool vec) {
  if (vec && tile0 + kTile <= L) {
    const int4* p = reinterpret_cast<const int4*>(keys + tile0) + threadIdx.x;
#pragma unroll
    for (int k = 0; k < kHistLoads; ++k) v[k] = __ldg(p + k * kThreads);
  } else {
#pragma unroll
    for (int k = 0; k < kHistLoads; ++k)
      v[k] = load4(keys, tile0 + 4 * (k * kThreads + threadIdx.x), L, vec);
  }
}

// A tile's keys into column `col` of a [kMaxBins + 1][stride] array of
// counters: a key into its digit's row (a digit >= nbins has a row too,
// which nothing reads), a key past the tile's end (kRagged: the last
// tile) into row kMaxBins.  One atomic a key and no branch.
template <bool kRagged>
__device__ __forceinline__ void count_tile(int* col, int stride,
                                           const int4 (&v)[kHistLoads],
                                           int tile_n, int shift, int mask) {
#pragma unroll
  for (int k = 0; k < kHistLoads; ++k) {
    const int j = 4 * (k * kThreads + threadIdx.x);
    const int key[4] = {v[k].x, v[k].y, v[k].z, v[k].w};
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      int d = (key[c] >> shift) & mask;
      if (kRagged) d = j + c < tile_n ? d : kMaxBins;
      atomicAdd(col + stride * d, 1);
    }
  }
}

// B1: block b counts tiles [b run, b run + run) one after the other,
// tile g into column g % kChunk of the chunk; a full chunk, and the
// run's end, is flushed (and zeroed, if tiles follow).  kFlush = false
// (a probe's): the counts stay in shared memory, hist is written only by
// a count no run gives.
template <int kChunk, bool kFlush = true>
__global__ void __launch_bounds__(kThreads, kHistPerSm)
digit_histogram_kernel(const int32_t* __restrict__ keys,
                       int32_t* __restrict__ hist, long long L, int shift,
                       int mask, int nbins, int nblocks, int run, int vec) {
  // + 1 row: keys past the end; + 1 column: no bank conflict in the flush
  __shared__ int chunk[kMaxBins + 1][kChunk + 1];
  const int t = threadIdx.x;
  const int first = blockIdx.x * run;
  const int ntiles = min(run, nblocks - first);
  const bool v = vec != 0;
  int4 cur[kHistLoads], nxt[kHistLoads];
  load_tile(cur, keys, (long long)first * kTile, L, v);
  // the flushed rows' columns the first chunk uses (kThreads >= nbins)
  if (t < nbins)
    for (int c = 0; c < min(ntiles, kChunk); ++c) chunk[t][c] = 0;
  __syncthreads();
  for (int g = 0; g < ntiles; ++g) {
    const long long tile0 = (long long)(first + g) * kTile;
    if (g + 1 < ntiles) load_tile(nxt, keys, tile0 + kTile, L, v);
    const int kc = g % kChunk;
    const long long left = L - tile0;
    if (left >= kTile)
      count_tile<false>(&chunk[0][kc], kChunk + 1, cur, kTile, shift, mask);
    else
      count_tile<true>(&chunk[0][kc], kChunk + 1, cur, (int)left, shift,
                       mask);
    const bool last = g == ntiles - 1;
    if (kFlush && (kc == kChunk - 1 || last)) {
      // the chunk's n tiles: thread t writes tile t % n of digits t / n,
      // t / n + kThreads / n, ..., so a store instruction covers runs of
      // one digit's tiles
      __syncthreads();
      const int n = kc + 1;
      const long long at = first + g - kc;
      const int c = t % n;
      for (int d = t / n; d < nbins && t < kThreads / n * n;
           d += kThreads / n) {
        hist[(long long)d * nblocks + at + c] = chunk[d][c];
        if (!last) chunk[d][c] = 0;
      }
      if (!last) __syncthreads();
    }
#pragma unroll
    for (int k = 0; k < kHistLoads; ++k) cur[k] = nxt[k];
  }
  if (!kFlush) {
    __syncthreads();
    if (t < nbins && chunk[t][0] == -1) hist[t] = 0;
  }
}

// A launch of a B1 kernel (the shipped one, or a probe's) with `run`
// tiles a block, as hist_run gives it or another.
template <typename Kernel>
int launch_histogram(Kernel kernel, const void* keys, void* hist,
                     long long L, int shift, int bits, int nbins,
                     int nblocks, int run, cudaStream_t s) {
  if (run < 1) return (int)cudaErrorInvalidValue;
  const int grid = (nblocks + run - 1) / run;
  const bool vec = (uintptr_t)keys % 16 == 0;
  kernel<<<grid, kThreads, 0, s>>>((const int32_t*)keys, (int32_t*)hist, L,
                                   shift, (1 << bits) - 1, nbins, nblocks,
                                   run, (int)vec);
  return (int)cudaGetLastError();
}

// The current device's SM count, read once a device.
int device_sms(int* sms) {
  static int known[64] = {0};
  int dev = 0;
  int rc = (int)cudaGetDevice(&dev);
  if (rc) return rc;
  if (dev < 0 || dev >= 64) return (int)cudaErrorInvalidDevice;
  if (!known[dev]) {
    int n = 0;
    rc = (int)cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount,
                                     dev);
    if (rc) return rc;
    known[dev] = n;
  }
  *sms = known[dev];
  return 0;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int bytes) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(bytes));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          int bytes) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(bytes));
}

// Wait until at most n of this thread's copy groups are in flight.
__device__ __forceinline__ void wait_all_but(int n) {
  switch (n) {
    case 0: asm volatile("cp.async.wait_group 0;\n" ::); break;
    case 1: asm volatile("cp.async.wait_group 1;\n" ::); break;
    case 2: asm volatile("cp.async.wait_group 2;\n" ::); break;
    default: asm volatile("cp.async.wait_group 3;\n" ::); break;
  }
}

// Copy keys [tile0, tile0 + kTile) of a word into shared memory, as 16 B
// vectors when every word is 16 B aligned; past L the copy is zero-filled.
__device__ __forceinline__ void stage_word(int32_t* dst,
                                           const int32_t* __restrict__ src,
                                           long long tile0, long long L,
                                           bool vec) {
  if (vec) {
    for (int j = threadIdx.x * 4; j < kTile; j += kThreads * 4) {
      const long long i = tile0 + j;
      const long long n = L - i < 4 ? (L - i > 0 ? L - i : 0) : 4;
      cp_async16(dst + j, src + (n ? i : 0), (int)n * 4);
    }
  } else {
    for (int j = threadIdx.x; j < kTile; j += kThreads) {
      const long long i = tile0 + j;
      cp_async4(dst + j, src + (i < L ? i : 0), i < L ? 4 : 0);
    }
  }
  asm volatile("cp.async.commit_group;\n" ::);
}

// B2: one tile of kTile keys per block.  The words land in shared memory
// in input order; warp w ranks keys [512 w, 512 w + 512) of the tile, its
// lane l key 512 w + 32 r + l in round r, so (warp, round, lane) is input
// order.  src[q] is the tile position of the key whose stable digit order
// is q.
template <int NC>
__global__ void __launch_bounds__(kThreads)
digit_placement_kernel(const int32_t* __restrict__ keys,
                       const int32_t* __restrict__ base,
                       const int32_t* __restrict__ payload,
                       int32_t* __restrict__ out,
                       const int32_t* __restrict__ cin0,
                       const int32_t* __restrict__ cin1,
                       int32_t* __restrict__ cout0,
                       int32_t* __restrict__ cout1, long long L, int shift,
                       int mask, int nbins, int nblocks, int kslot, int vec) {
  // words in input order: [0] payload, [1..NC] carried, [NC + 1] the keys
  // unless carried (kslot says where they are), then src[] and digits
  extern __shared__ int32_t staged[];
  const int nwords = NC + 1 + (kslot == NC + 1);
  uint16_t* src = reinterpret_cast<uint16_t*>(staged + nwords * kTile);
  uint8_t* dig = reinterpret_cast<uint8_t*>(src + kTile);
  __shared__ int cnt[kWarps][kMaxBins + 1];  // + the bin of unplaced keys
  __shared__ int gbase[kMaxBins];            // global position - tile position
  __shared__ int wsum[kWarps];
  __shared__ int nvalid;
  const int t = threadIdx.x;
  const int warp = t / 32;
  const int lane = t % 32;
  const unsigned lanemask_lt = (1u << lane) - 1u;
  const int unplaced = nbins;  // tail and out-of-contract keys
  const int nbits = 32 - __clz(nbins);  // bits of 0..unplaced
  const long long tile0 = (long long)blockIdx.x * kTile;
  const bool v = vec != 0;

  // 1. the key word first, then every other word, each read once
  stage_word(staged + kslot * kTile, keys, tile0, L, v);
  if (payload) stage_word(staged, payload, tile0, L, v);
  if (NC > 0 && kslot != 1) stage_word(staged + kTile, cin0, tile0, L, v);
  if (NC > 1 && kslot != 2) stage_word(staged + 2 * kTile, cin1, tile0, L, v);
  for (int k = t; k < kWarps * (kMaxBins + 1); k += kThreads)
    (&cnt[0][0])[k] = 0;
  const int gb = t < nbins ? __ldg(base + (long long)t * nblocks + blockIdx.x)
                           : 0;
  // groups complete in order: all but the later words' = the keys
  wait_all_but((payload != nullptr) + (NC > 0 && kslot != 1) +
               (NC > 1 && kslot != 2));
  __syncthreads();

  // 2. rank among the warp's earlier keys of the same digit: the peers
  //    are matched bit by bit with ballots
  const int tile_n = L - tile0 < kTile ? (int)(L - tile0) : kTile;
  const int32_t* skey = staged + kslot * kTile;
  int dr[kPerThread];  // (rank in warp << 16 | digit)
#pragma unroll
  for (int r = 0; r < kPerThread; ++r) {
    const int j = warp * kWarpSpan + 32 * r + lane;
    int d = (skey[j] >> shift) & mask;
    d = j < tile_n && d < nbins ? d : unplaced;
    unsigned peers = 0xffffffffu;
    for (int b = 0; b < nbits; ++b) {
      const unsigned m = __ballot_sync(0xffffffffu, (d >> b) & 1);
      peers &= (d >> b) & 1 ? m : ~m;
    }
    const int before = cnt[warp][d];
    __syncwarp();
    if (lane == __ffs(peers) - 1) cnt[warp][d] = before + __popc(peers);
    dr[r] = (before + __popc(peers & lanemask_lt)) << 16 | d;
    __syncwarp();
  }
  __syncthreads();

  // 3. thread t owns digit t: its start in the tile (a block-wide
  //    exclusive scan of the digit totals), then each warp's start
  int c[kWarps], tot = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    c[w] = cnt[w][t];
    tot += c[w];
  }
  int incl = tot;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int x = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += x;
  }
  if (lane == 31) wsum[warp] = incl;
  __syncthreads();
  for (int w = 0; w < warp; ++w) incl += wsum[w];
  const int start = incl - tot;
  if (t == nbins) nvalid = start;
  if (t == kThreads - 1 && nbins == kMaxBins) nvalid = incl;
  int run = start;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    cnt[w][t] = run;
    run += c[w];
  }
  if (t < nbins) gbase[t] = gb - start;
  __syncthreads();

  // 4. the tile's stable digit order
#pragma unroll
  for (int r = 0; r < kPerThread; ++r) {
    const int d = dr[r] & 0xffff;
    if (d < nbins) {
      const int q = cnt[warp][d] + (dr[r] >> 16);
      src[q] = (uint16_t)(warp * kWarpSpan + 32 * r + lane);
      dig[q] = (uint8_t)d;
    }
  }
  asm volatile("cp.async.wait_group 0;\n" ::);
  __syncthreads();

  // 5. write out in that order: neighbouring threads, neighbouring
  //    addresses inside each digit's run
  const int n = nvalid;
  for (int q = t; q < n; q += kThreads) {
    const int j = src[q];
    const int g = gbase[dig[q]] + q;
    out[g] = payload ? staged[j] : (int32_t)(tile0 + j);
    if (NC > 0) cout0[g] = staged[kTile + j];
    if (NC > 1) cout1[g] = staged[2 * kTile + j];
  }
}

template <int NC>
int launch_placement(const int32_t* keys, const int32_t* base,
                     const int32_t* payload, int32_t* out,
                     const int32_t* const* cin, int32_t* const* cout,
                     long long L, int shift, int mask, int nbins,
                     int nblocks, cudaStream_t s) {
  // the keys' word: a carried one if they are carried, else their own
  int kslot = NC + 1;
  for (int c = NC - 1; c >= 0; --c)
    if (cin[c] == keys) kslot = c + 1;
  const int nwords = NC + 1 + (kslot == NC + 1);
  const size_t smem = (size_t)nwords * kTile * sizeof(int32_t) +
                      kTile * (sizeof(uint16_t) + sizeof(uint8_t));
  static int sized = 0;  // the largest size set so far for this kernel
  if ((int)smem > sized) {
    const int rc = (int)cudaFuncSetAttribute(
        digit_placement_kernel<NC>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (rc) return rc;
    sized = (int)smem;
  }
  bool vec = (uintptr_t)keys % 16 == 0 && (uintptr_t)payload % 16 == 0;
  for (int c = 0; c < NC; ++c) vec = vec && (uintptr_t)cin[c] % 16 == 0;
  digit_placement_kernel<NC><<<nblocks, kThreads, smem, s>>>(
      keys, base, payload, out, cin[0], cin[1], cout[0], cout[1], L, shift,
      mask, nbins, nblocks, kslot, (int)vec);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int digit_histogram_launch(const void* keys, void* hist,
                                      long long L, int shift, int bits,
                                      int nbins, int nblocks,
                                      void* stream) {
  int sms = 0;
  const int rc = device_sms(&sms);
  if (rc) return rc;
  return launch_histogram(digit_histogram_kernel<kHistChunk>, keys, hist, L,
                          shift, bits, nbins, nblocks, hist_run(nblocks, sms),
                          (cudaStream_t)stream);
}

// ncarry words (0-2) ride along: carry_out[c][pos] = carry_in[c][i]
// wherever the payload goes; a carried word may be the keys themselves.
extern "C" int digit_placement_launch(const void* keys, const void* base,
                                      const void* payload, void* out,
                                      const void* carry_in0,
                                      const void* carry_in1,
                                      void* carry_out0, void* carry_out1,
                                      int ncarry, long long L, int shift,
                                      int bits, int nbins, int nblocks,
                                      void* stream) {
  const int32_t* cin[2] = {(const int32_t*)carry_in0,
                           (const int32_t*)carry_in1};
  int32_t* cout[2] = {(int32_t*)carry_out0, (int32_t*)carry_out1};
  const int32_t* k = (const int32_t*)keys;
  const int32_t* b = (const int32_t*)base;
  const int32_t* p = (const int32_t*)payload;
  int32_t* o = (int32_t*)out;
  const int mask = (1 << bits) - 1;
  cudaStream_t s = (cudaStream_t)stream;
  switch (ncarry) {
    case 0:
      return launch_placement<0>(k, b, p, o, cin, cout, L, shift, mask,
                                 nbins, nblocks, s);
    case 1:
      return launch_placement<1>(k, b, p, o, cin, cout, L, shift, mask,
                                 nbins, nblocks, s);
    case 2:
      return launch_placement<2>(k, b, p, o, cin, cout, L, shift, mask,
                                 nbins, nblocks, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

extern "C" int radix_tile(void) { return kTile; }
extern "C" int radix_max_bins(void) { return kMaxBins; }
extern "C" int radix_max_carry(void) { return kMaxCarry; }
extern "C" int radix_hist_per_sm(void) { return kHistPerSm; }
extern "C" int radix_hist_chunk(void) { return kHistChunk; }
extern "C" int radix_hist_run(int nblocks, int sms) {
  return hist_run(nblocks, sms);
}

// the instances the radix chain launches (B2 with the keys not among the
// carried words: its largest staging)
namespace {
constexpr long long placement_smem(int nc) {
  return (long long)(nc + 2) * kTile * 4 + kTile * 3;
}
const KernelResource kResources[] = {
    {"digit_histogram", (const void*)digit_histogram_kernel<kHistChunk>,
     kThreads, 0},
    {"digit_placement_c0", (const void*)digit_placement_kernel<0>, kThreads,
     placement_smem(0)},
    {"digit_placement_c1", (const void*)digit_placement_kernel<1>, kThreads,
     placement_smem(1)},
    {"digit_placement_c2", (const void*)digit_placement_kernel<2>, kThreads,
     placement_smem(2)},
};
}  // namespace
REPRO_RESOURCE_TABLE(kResources)
