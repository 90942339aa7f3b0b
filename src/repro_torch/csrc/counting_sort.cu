// B11: stable counting-sort placement (Part 2 of the paper's planner,
// method="pallas").
//
// Replaces repro/kernels/counting_sort/counting_sort.py:placement
// (_placement_kernel): pos[i] = offsets[b, key_i] + (the number of keys
// equal to key_i earlier in block b), where b = i / block_b and
// offsets[nblocks, nbins] comes from B12 and two scans
// (hist/ops.py:block_offsets).  That is the paper's placement loop
// rank[jrS[ii[i]]++] = i with one private counter row jrS per block.
// The TPU kernel gathers the base with a one-hot matvec and counts the
// earlier equal keys with a [B, B] equality tile, both for its matrix
// unit; neither has a place here.
//
// What bounds it on the H100: bytes would (the keys once, 4L B, the
// table once, 4 * nbins * nblocks B, the positions once, 4L B), but the
// ++ makes the keys of one histogram block a chain: a key's position
// depends on every earlier equal key of its block.
//
// What this design does about it: the chain advances a tile of kTile
// (8,192) keys at a time.  Each histogram block is cut into tiles of T =
// min(kTile, block_b) keys (a tile never straddles two blocks), one CUDA
// block of 16 warps per tile, and each tile does three things:
//  1. with no waiting: loads its keys (coalesced), and sorts them
//     stably in shared memory by an LSD radix sort over the key's
//     bit_length(nbins) bits, 8 bits a pass, ranking each digit with
//     B2's stable warp ranking (csrc/radix_sort.cu: the lanes of equal
//     digit, warp-private counters, a scan across warps), the lanes found
//     by eight ballots instead of __match_any_sync, whose cost grows with
//     the distinct values in the warp.  Out-of-range keys sort last
//     under the sentinel nbins.  A max-scan over the sorted keys gives
//     each key its run's start: its rank among the equal keys of the
//     tile is (sorted position - run start), and each run's end holds
//     (key, count).
//  2. once per tile, in order along its histogram block, and apart for
//     each sixteenth of the key range: warp w owns the keys in [w *
//     chunk, (w + 1) * chunk), chunk = ceil(nbins / 16), which are one
//     segment of the sorted tile.  It waits until the previous tile of
//     the block has published the range (relaxed polls, then
//     fence.acq_rel.gpu), takes base = cnt[key] and stores cnt[key] =
//     base + count for its runs (the loads of 8 run ends a lane before
//     their stores), and publishes (red.release.gpu from every lane on
//     the (block, range) flag).  The counters are the block's row of the
//     table in device memory (read through the L2, never the SM's L1),
//     so one design serves every nbins.  The sixteen ranges of a tile
//     hand off side by side: a range's next tile can start on its part
//     of the counters while this tile's other ranges are still at work.
//  3. writes pos = -1 for an out-of-range key, else base(run) + rank,
//     scattered back to input order in shared memory and stored
//     coalesced.
// Tiles take an atomic ticket (zeroed by the wrapper for every call),
// mapped interleaved across the histogram blocks: block = ticket mod
// nblocks, step = ticket / nblocks.  A waiting tile's predecessor holds
// a smaller ticket, so it has started: no deadlock whatever the number of
// resident blocks, and the resident tiles spread over all the chains.
// The critical path is block_b / T handoffs per (block, range).
//
// What still bounds it: with the table in the L2 (Table 4.1's sets,
// 7.8 MB) the chain, 8 handoffs of a few L2 round trips each.  With the
// table past the L2 (the 5e7 set, 192 MB) the counters' random traffic:
// every key reads and writes one counter of a 4 MB row, a 32-byte
// sector each, so the table moves about 16 times its size in scattered
// sectors, and each handoff waits on its sectors.
#include <cstdint>
#include <cuda_runtime.h>
#include "resources.cuh"

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kPerThread = 16;
constexpr int kTile = kThreads * kPerThread;  // keys per tile, at most
constexpr int kWarpSpan = kTile / kWarps;     // contiguous keys per warp
constexpr int kDigitBits = 8;
constexpr int kDigits = 1 << kDigitBits;

constexpr int kChunk = 8;  // run ends a lane gathers at once
// one padding word per 32: a thread's 16 consecutive entries (16t + i)
// and a warp's 32 consecutive entries both fall in 32 distinct banks
__device__ __forceinline__ int pad(int j) { return j + (j >> 5); }
constexpr int kPadded = kTile + kTile / 32;

// the first of the tile's kTile sorted keys that is >= v
__device__ __forceinline__ int lower_bound(const unsigned* sorted,
                                           unsigned v) {
  int lo = 0, hi = kTile;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (sorted[pad(mid)] < v) lo = mid + 1;
    else hi = mid;
  }
  return lo;
}

__device__ __forceinline__ int ld_relaxed(const int* p) {
  int v;
  asm volatile("ld.relaxed.gpu.global.s32 %0, [%1];"
               : "=r"(v) : "l"(p) : "memory");
  return v;
}

// Wait until *p >= v (the flags only grow): relaxed polls, then a fence
// that makes the last poll an acquire.
__device__ __forceinline__ void wait_for(const int* p, int v) {
  while (ld_relaxed(p) < v) {
  }
  asm volatile("fence.acq_rel.gpu;" ::: "memory");
}

__device__ __forceinline__ void red_release_add(int* p, int v) {
  asm volatile("red.release.gpu.global.add.s32 [%0], %1;"
               :: "l"(p), "r"(v) : "memory");
}

// The lanes holding the same 8-bit digit, from one ballot a bit (what
// __match_any_sync computes, without its cost on a warp of distinct
// values)
__device__ __forceinline__ unsigned match_digit(unsigned d) {
  unsigned m = 0xffffffffu;
#pragma unroll
  for (int bit = 0; bit < kDigitBits; ++bit) {
    const unsigned set = (d >> bit) & 1u;
    const unsigned b = __ballot_sync(0xffffffffu, set);
    m &= set ? b : ~b;
  }
  return m;
}

struct Smem {
  unsigned key[kPadded];    // sorted keys; then the run bases; then pos
  uint16_t idx[kPadded];    // each sorted key's index in the tile
  uint16_t start[kPadded];  // the start of each sorted key's run
  int cnt[kWarps][kDigits];
  int warp_max[kWarps];
  int ticket;
};

__global__ void __launch_bounds__(kThreads, 2)
placement_tiles_kernel(const int32_t* __restrict__ keys,
                       int32_t* __restrict__ table,
                       int32_t* __restrict__ pos, int* __restrict__ sync,
                       long long L, int nbins, long long block_b, int tile,
                       int nblocks, int key_bits) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>(smem_raw);
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const unsigned lanemask_lt = (1u << lane) - 1u;
  // sync[0] is the ticket, sync[1 + b] the steps histogram block b has
  // published
  if (t == 0) sm.ticket = atomicAdd(sync, 1);
  __syncthreads();
  const int ticket = sm.ticket;
  const int b = ticket % nblocks;
  const long long step = ticket / nblocks;
  const long long blk0 = (long long)b * block_b;
  const long long blk1 = blk0 + block_b < L ? blk0 + block_b : L;
  const long long t0 = blk0 + step * tile;
  if (t0 >= blk1) return;  // past the end of the last (partial) block
  const int n = (int)((t0 + tile < blk1 ? t0 + tile : blk1) - t0);
  const unsigned sentinel = (unsigned)nbins;

  // -- 1. stable radix sort of (key, index) in the tile ------------------
  unsigned k[kPerThread];
  int e0 = warp * kWarpSpan + lane;  // this lane's s-th key: e0 + 32 s
#pragma unroll
  for (int s = 0; s < kPerThread; ++s) {
    const int e = e0 + 32 * s;
    unsigned v = sentinel;
    if (e < n) {
      const int kk = __ldg(keys + t0 + e);
      if (kk >= 0 && kk < nbins) v = (unsigned)kk;
    }
    k[s] = v;
    sm.idx[pad(e)] = (uint16_t)e;
  }
  for (int shift = 0; shift < key_bits; shift += kDigitBits) {
    // a key's rank in its warp's span (low 16 bits) and its index in
    // the tile (high 16 bits)
    unsigned ci[kPerThread];
    for (int j = t; j < kWarps * kDigits; j += kThreads)
      sm.cnt[j / kDigits][j % kDigits] = 0;
    __syncthreads();
    // rank each key among the earlier equal digits of its warp's span
#pragma unroll
    for (int s = 0; s < kPerThread; ++s) {
      const unsigned id = sm.idx[pad(e0 + 32 * s)];
      const int d = (k[s] >> shift) & (kDigits - 1);
      const unsigned peers = match_digit(d);
      ci[s] = (sm.cnt[warp][d] + __popc(peers & lanemask_lt)) | (id << 16);
      __syncwarp();
      if (lane == __ffs(peers) - 1) sm.cnt[warp][d] += __popc(peers);
      __syncwarp();
    }
    __syncthreads();
    // exclusive scan over (digit, warp): thread d < kDigits owns digit d
    int run = 0;
    if (t < kDigits) {
      for (int w = 0; w < kWarps; ++w) {
        const int v = sm.cnt[w][t];
        sm.cnt[w][t] = run;
        run += v;
      }
    }
    int incl = run;  // block inclusive scan of the digit totals
#pragma unroll
    for (int dd = 1; dd < 32; dd <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, incl, dd);
      if (lane >= dd) incl += y;
    }
    if (lane == 31) sm.warp_max[warp] = incl;
    __syncthreads();
    if (t < kDigits) {
      int before = incl - run;
      for (int w = 0; w < warp; ++w) before += sm.warp_max[w];
      for (int w = 0; w < kWarps; ++w) sm.cnt[w][t] += before;
    }
    __syncthreads();
#pragma unroll
    for (int s = 0; s < kPerThread; ++s) {
      const int d = (k[s] >> shift) & (kDigits - 1);
      const int p = pad(sm.cnt[warp][d] + (int)(ci[s] & 0xffffu));
      sm.key[p] = k[s];
      sm.idx[p] = (uint16_t)(ci[s] >> 16);
    }
    __syncthreads();
#pragma unroll
    for (int s = 0; s < kPerThread; ++s) k[s] = sm.key[pad(e0 + 32 * s)];
  }
  // key_bits >= 1 (nbins >= 1): sm.key holds the sorted keys

  // -- runs: thread t owns the sorted positions 16t .. 16t + 15 ---------
  const int j0 = t * kPerThread;
  unsigned sk[kPerThread];
  int start[kPerThread];
#pragma unroll
  for (int i = 0; i < kPerThread; ++i) sk[i] = sm.key[pad(j0 + i)];
  const unsigned prev = j0 ? sm.key[pad(j0 - 1)] : ~0u;
  int m = -1;
#pragma unroll
  for (int i = 0; i < kPerThread; ++i) {
    if (sk[i] != (i ? sk[i - 1] : prev)) m = j0 + i;
    start[i] = m;
  }
  // block inclusive max-scan of the thread's last start
  int w_in = m;
#pragma unroll
  for (int dd = 1; dd < 32; dd <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, w_in, dd);
    if (lane >= dd) w_in = max(w_in, y);
  }
  if (lane == 31) sm.warp_max[warp] = w_in;
  __syncthreads();
  int carry = __shfl_up_sync(0xffffffffu, w_in, 1);
  if (lane == 0) carry = -1;
  for (int w = 0; w < warp; ++w) carry = max(carry, sm.warp_max[w]);
#pragma unroll
  for (int i = 0; i < kPerThread; ++i) {
    start[i] = max(start[i], carry);
    sm.start[pad(j0 + i)] = (uint16_t)start[i];
  }
  __syncthreads();

  // -- 2. the handoff: warp w owns the keys in [w * chunk, (w + 1) * chunk)
  // and hands their counters on along block b, apart from the other warps
  const unsigned chunk = (unsigned)((nbins + kWarps - 1) / kWarps);
  const unsigned key_lo = min(warp * chunk, sentinel);
  const unsigned key_hi = min(key_lo + chunk, sentinel);
  const int lo = lower_bound(sm.key, key_lo), hi = lower_bound(sm.key, key_hi);
  __syncthreads();  // every search is done before a run base lands in sm.key
  int32_t* cnt = table + (long long)b * nbins;
  // every lane adds 1 to its range's flag when it is done: a step is
  // published when the flag reaches 32 * (step + 1).  Each lane acquires
  // and releases for itself.
  int* flag = sync + 1 + (long long)b * kWarps + warp;
  wait_for(flag, 32 * (int)step);
  for (int c0 = lo; c0 < hi; c0 += 32 * kChunk) {
    unsigned kk[kChunk];  // the key of a run's end, else ~0u
    int base[kChunk];
#pragma unroll
    for (int u = 0; u < kChunk; ++u) {
      const int j = c0 + 32 * u + lane;
      kk[u] = ~0u;
      if (j < hi) {
        const unsigned k0 = sm.key[pad(j)];
        if (j + 1 == hi || sm.key[pad(j + 1)] != k0) kk[u] = k0;
      }
    }
    // the run ends hold distinct keys: all loads go out before the stores
#pragma unroll
    for (int u = 0; u < kChunk; ++u)
      base[u] = kk[u] != ~0u ? __ldcg(cnt + kk[u]) : 0;
    __syncwarp();  // every key of the chunk is read before a base lands
#pragma unroll
    for (int u = 0; u < kChunk; ++u) {
      if (kk[u] != ~0u) {
        const int j = c0 + 32 * u + lane, s = sm.start[pad(j)];
        __stcg(cnt + kk[u], base[u] + (j - s + 1));
        sm.key[pad(s)] = (unsigned)(base[u] - s);  // the run's base
      }
    }
    __syncwarp();
  }
  red_release_add(flag, 1);
  __syncthreads();

  // -- 3. positions, back to input order, stored coalesced ---------------
  int p[kPerThread];
#pragma unroll
  for (int i = 0; i < kPerThread; ++i)
    p[i] = sk[i] < sentinel ? (int)sm.key[pad(start[i])] + j0 + i : -1;
  uint16_t id[kPerThread];
#pragma unroll
  for (int i = 0; i < kPerThread; ++i) id[i] = sm.idx[pad(j0 + i)];
  __syncthreads();
#pragma unroll
  for (int i = 0; i < kPerThread; ++i) sm.key[pad(id[i])] = (unsigned)p[i];
  __syncthreads();
  for (int e = t; e < n; e += kThreads) pos[t0 + e] = (int32_t)sm.key[pad(e)];
}

}  // namespace

// `table` is advanced in place: the caller's copy of offsets.  `sync`
// holds placement_sync_words(nblocks) zeroed int32: the ticket and one
// flag per (block, key range).
extern "C" int placement_launch(const void* keys, void* table, void* pos,
                                void* sync, long long L, int nbins,
                                long long block_b, int nblocks,
                                void* stream) {
  const int tile = block_b < kTile ? (int)block_b : kTile;
  const long long span = block_b < L ? block_b : L;  // keys a block holds
  const long long per_block = (span + tile - 1) / tile;
  const long long ntickets = per_block * nblocks;
  if (ntickets >= (1ll << 31) || per_block >= (1ll << 25))
    return (int)cudaErrorInvalidValue;
  int key_bits = 0;
  while (key_bits < 32 && (nbins >> key_bits) != 0) ++key_bits;
  const int rc = (int)cudaFuncSetAttribute(
      placement_tiles_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)sizeof(Smem));
  if (rc) return rc;
  placement_tiles_kernel<<<(unsigned)ntickets, kThreads, sizeof(Smem),
                           (cudaStream_t)stream>>>(
      (const int32_t*)keys, (int32_t*)table, (int32_t*)pos, (int*)sync, L,
      nbins, block_b, tile, nblocks, key_bits);
  return (int)cudaGetLastError();
}

extern "C" long long placement_sync_words(long long nblocks) {
  return 1 + nblocks * kWarps;
}

extern "C" int placement_tile(void) { return kTile; }

namespace {
const KernelResource kResources[] = {
    {"placement", (const void*)placement_tiles_kernel, kThreads,
     (long long)sizeof(Smem)},
};
}  // namespace
REPRO_RESOURCE_TABLE(kResources)
