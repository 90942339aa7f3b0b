// One stable LSD digit pass of the (col, row) radix planner: B1 + B2.
//
// Replaces repro/kernels/radix_sort/radix_sort.py:
//   digit_block_histogram (_digit_hist_kernel)       -> digit_histogram_kernel
//   digit_placement (_digit_placement_kernel), fused
//   with the payload scatter of radix_sort/ops.py     -> digit_placement_kernel
//
// What bounds it on the H100: bytes.  B1 reads the pass's key word once
// (4L B) and writes nbins * nblocks int32 counters (under 1% of that).
// B2 reads the key word, the payload and the carried words once and
// writes the payload and the carried words once: 12-24 B a key, 108L B
// over the six passes of the 5e7 set.  The work per key is a shift, a
// mask and a few shared-memory operations, far below the integer rate.
//
// B1: each block counts one tile of TILE = 4096 keys (256 threads x 16)
// in shared memory and writes its histogram digit-major (hist[d *
// nblocks + b]), so one exclusive scan over the flat array (outside, in
// PyTorch) yields every (digit, tile) base.
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
  digit_histogram_kernel<<<nblocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const int32_t*)keys, (int32_t*)hist, L, shift, (1 << bits) - 1, nbins,
      nblocks);
  return (int)cudaGetLastError();
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

// the instances the radix chain launches (B2 with the keys not among the
// carried words: its largest staging)
namespace {
constexpr long long placement_smem(int nc) {
  return (long long)(nc + 2) * kTile * 4 + kTile * 3;
}
const KernelResource kResources[] = {
    {"digit_histogram", (const void*)digit_histogram_kernel, kThreads, 0},
    {"digit_placement_c0", (const void*)digit_placement_kernel<0>, kThreads,
     placement_smem(0)},
    {"digit_placement_c1", (const void*)digit_placement_kernel<1>, kThreads,
     placement_smem(1)},
    {"digit_placement_c2", (const void*)digit_placement_kernel<2>, kThreads,
     placement_smem(2)},
};
}  // namespace
REPRO_RESOURCE_TABLE(kResources)
