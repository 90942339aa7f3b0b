// Parts 3-4 of the plan in one pass over the sorted stream (K1) and a
// small tail (K2): the sorted keys, the boundary flags and their scan, the
// output slots and the CSC structure of a (col, row)-sorted triplet stream.
//
// Replaces no TPU kernel.  The JAX package leaves Parts 3-4 to XLA
// (repro/sparse/pattern.py:pattern_from_sorted: the gathers through perm,
// the flags, a cumsum and two searchsorted lookups), and so did the port
// until this kernel.  In eager PyTorch that is about 30 launches a call,
// each a full pass over an L-long stream in device memory: at the FEM
// matrix's L = 7.19e7 (288 MB a stream, over five times the 50 MB L2) it
// took 7.9 ms of a 14 ms assembly, more than the radix sort before it.
//
// Outputs, bit-identical to the plain version (kernels/pattern_build/ref.py)
// on every input:
//   srows, scols  rows[perm], cols[perm] (the gathered entry only)
//   slot[i]       (uniques at or before i) - 1 where r_s[i] < M, else nzmax
//   indices[s]    the row of unique s for s < min(nnz, nzmax); M past nnz
//   indptr[j]     the uniques before the first position with c_s >= j
//   nnz           indptr[N]
// A unique is a position whose key (c_s, r_s) differs from the one before
// it and whose row is below M (padding rows sort to the end of their column
// and never count).
//
// What bounds it on the H100: bytes.  The pass reads perm (4L B), gathers
// rows and cols through it (8L B) and writes srows, scols and slot (12L B),
// indices (4 nzmax B) and indptr (4(N+1) B): 24L + 4 nzmax + 4(N+1) B, 2.03
// GB at the FEM matrix (0.61 ms at 3.35 TB/s).  Where perm is random
// (Table 4.1 set 2) each gathered word costs a 32 B sector from HBM, so no
// design that gathers beats about 84L B there (1.25 ms at L = 5e7); in fact
// random sectors come at about a third of the peak (B3''s gather floor).
//
// The design.  K0 looks at how far apart the gathers fall: every block
// reads kSample pairs of neighbouring entries of perm, spread over the
// stream.  Where most pairs lie within kNear words of each other (the FEM
// matrix: a column's triplets come from a few elements, in the L2), it does
// nothing.  Elsewhere (a random order) it interleaves rows and cols into
// (row, col) pairs, one streaming pass of 16L B, so that K1 gathers one
// 8 B pair a position, one sector where two words cost two: at set 2's
// L = 5e7 that took the pass from 3.47 to 2.28 ms, while in the FEM
// matrix's order pairs cost 0.44 ms more (1.41 against 0.98 ms, the same
// outputs), hence the sample.  Every block decides
// alike, and block 0 leaves the choice for K1 in device memory.
// K1 is Merrill and Garland's single-pass scan with decoupled look-back
// (csrc/lookback.cuh) under an int32 count: tiles of 256 threads x kPer
// positions take their ids from an atomic ticket, in stream order.
//  1. Load: each thread reads its share of perm as 16 B vectors (striped,
//     streaming) and starts all its kPer gathers (pairs, or rows and cols)
//     before it uses any, so that many random loads are in flight a
//     thread.  It writes
//     srows and scols from its registers as 16 B vectors.  The presorted
//     entry (SparsePattern.update's merge) reads r_s and c_s instead and
//     writes neither.  Thread 0 fetches the key before the tile (one more
//     gather).  The keys go to shared memory, padded by one word in 32.
//  2. Flags and scan: each thread takes kPer consecutive positions, flags
//     the uniques (a bit mask in a register) and counts them; a warp scan
//     and a pass over the 8 warp totals give each thread the uniques before
//     it in the tile.
//  3. Carry: the tile publishes its count at once (tile 0 its prefix) and
//     warp 0 looks back to the nearest published prefix; the count is an
//     integer sum, so the prefix is exact whatever the timing.
//  4. Scatter side, in place of both searchsorted lookups.  A tile's
//     uniques take consecutive slots from its prefix, so each unique puts
//     its row into a compacted shared array and the tile stores indices in
//     one coalesced stretch; the slots go out through shared memory as
//     16 B vectors.  A position where the column changes writes
//     indptr[j] = (uniques before it) for every j in (c_s[i-1], c_s[i]]
//     (position 0: [0, c_s[0]]), clipped to [0, N]: that covers every
//     empty column inside the stream.  The thread writes a gap of fewer
//     than kWideGap columns itself; a wider one its whole warp writes,
//     32 lanes a store, so a gap of G columns costs G / 32 stores (a
//     few triplets over millions of columns stay well under a ms).
// K2 reads the total count (written by the last tile) and c_s[L-1] from
// device memory, never the host, and writes indices[total:nzmax] = M,
// indptr[c_s[L-1]+1 : N+1] = total and nnz.  Nothing waits on the host,
// and the launches capture into a CUDA graph.
#include <cstdint>
#include <cuda_runtime.h>
#include "resources.cuh"

#include "lookback.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kPer = 8;                    // positions a thread
constexpr int kTile = kThreads * kPer;     // positions a tile
constexpr int kPadded = kTile + kTile / 32;
// resident tiles an SM asks for: 5 caps K1 at 48 registers, 4% faster than
// 4 (56 registers) on the FEM matrix and as fast on set 2
constexpr int kMinBlocks = 5;
constexpr int kTailThreads = 256;
// K0: sampled neighbours of perm, and the distance (in words) below which
// a pair counts as near: 1 MB of a key stream, where the FEM matrix's
// neighbours lie at most 18 n words apart (144 KB at n = 1,999)
constexpr int kSample = 256;
constexpr long long kNear = 1 << 18;
// a run of empty columns this wide or wider is written by the whole warp
constexpr long long kWideGap = 32;

__device__ __forceinline__ int pad(int j) { return j + j / 32; }

// The count the tiles carry: an exact int32 sum.
struct CountOp {
  using Acc = int;
  static __device__ int identity() { return 0; }
  static __device__ int of(int a) { return a; }
  static __device__ int combine(int a, int b) { return a + b; }
};

// A tile's descriptor: one 64-bit word, status in the high half and the
// count in the low half, stored and loaded whole, so a reader sees both or
// neither.  The zeroed word reads as not yet.  A tile overwrites its
// aggregate with its prefix; a reader takes whichever it sees, and the
// fold gives the same count either way.
struct DescI32 {
  unsigned long long* w;
  __device__ void publish(int tile, int status, int v) const {
    const unsigned long long x =
        ((unsigned long long)(unsigned)status << 32) | (unsigned)v;
    asm volatile("st.relaxed.gpu.global.u64 [%0], %1;"
                 :: "l"(w + tile), "l"(x) : "memory");
  }
  __device__ int read(int tile, int& v) const {
    unsigned long long x;
    asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];"
                 : "=l"(x) : "l"(w + tile) : "memory");
    v = (int)(unsigned)(x & 0xffffffffull);
    return (int)(x >> 32);
  }
};

// The keys of a tile: gathered through perm (from K0's pairs where it made
// them), or read as they are.
template <bool kGather>
struct Keys {
  const int32_t* rows;  // the input rows, or r_s
  const int32_t* cols;  // the input cols, or c_s
  const int32_t* perm;  // unused by the presorted entry
  const int2* pairs;    // (rows, cols) interleaved, where use_pairs
  bool use_pairs;
  __device__ void fetch(int32_t p, int32_t& r, int32_t& c) const {
    if (use_pairs) {
      const int2 q = __ldg(pairs + p);
      r = q.x;
      c = q.y;
    } else {
      r = __ldg(rows + p);
      c = __ldg(cols + p);
    }
  }
  __device__ void at(long long pos, int32_t& r, int32_t& c) const {
    if (kGather) {
      fetch(__ldg(perm + pos), r, c);
    } else {
      r = __ldg(rows + pos);
      c = __ldg(cols + pos);
    }
  }
};

// Register i of a thread holds tile position vec_at(i): 16 B vectors
// striped across the threads, or single words striped.
template <bool kVec>
__device__ __forceinline__ int vec_at(int i) {
  return kVec ? 4 * ((i / 4) * kThreads + (int)threadIdx.x) + (i & 3)
              : i * kThreads + (int)threadIdx.x;
}

// Step 1: the tile's keys into registers (srows, scols written out in the
// gathered entry), then into shared memory.
template <bool kGather, bool kVec>
__device__ __forceinline__ void load_keys(const Keys<kGather>& keys,
                                          int32_t* __restrict__ srows,
                                          int32_t* __restrict__ scols,
                                          long long t0, long long L,
                                          int32_t* sr, int32_t* sc) {
  int32_t r[kPer], c[kPer];
  if (kVec) {
    if (kGather) {
      int32_t p[kPer];
      const int4* pv = reinterpret_cast<const int4*>(keys.perm + t0);
#pragma unroll
      for (int q = 0; q < kPer / 4; ++q) {
        const int4 a = __ldcs(pv + q * kThreads + threadIdx.x);
        p[4 * q] = a.x;
        p[4 * q + 1] = a.y;
        p[4 * q + 2] = a.z;
        p[4 * q + 3] = a.w;
      }
#pragma unroll
      for (int i = 0; i < kPer; ++i)  // every gather before any use
        keys.fetch(p[i], r[i], c[i]);
#pragma unroll
      for (int q = 0; q < kPer / 4; ++q) {
        const int o = q * kThreads + threadIdx.x;
        __stcs(reinterpret_cast<int4*>(srows + t0) + o,
               make_int4(r[4 * q], r[4 * q + 1], r[4 * q + 2], r[4 * q + 3]));
        __stcs(reinterpret_cast<int4*>(scols + t0) + o,
               make_int4(c[4 * q], c[4 * q + 1], c[4 * q + 2], c[4 * q + 3]));
      }
    } else {
      const int4* rv = reinterpret_cast<const int4*>(keys.rows + t0);
      const int4* cv = reinterpret_cast<const int4*>(keys.cols + t0);
#pragma unroll
      for (int q = 0; q < kPer / 4; ++q) {
        const int4 a = __ldcs(rv + q * kThreads + threadIdx.x);
        const int4 b = __ldcs(cv + q * kThreads + threadIdx.x);
        r[4 * q] = a.x;
        r[4 * q + 1] = a.y;
        r[4 * q + 2] = a.z;
        r[4 * q + 3] = a.w;
        c[4 * q] = b.x;
        c[4 * q + 1] = b.y;
        c[4 * q + 2] = b.z;
        c[4 * q + 3] = b.w;
      }
    }
  } else {
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const long long pos = t0 + vec_at<false>(i);
      r[i] = c[i] = 0;
      if (pos < L) keys.at(pos, r[i], c[i]);
    }
    if (kGather) {
#pragma unroll
      for (int i = 0; i < kPer; ++i) {
        const long long pos = t0 + vec_at<false>(i);
        if (pos < L) {
          srows[pos] = r[i];
          scols[pos] = c[i];
        }
      }
    }
  }
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int j = vec_at<kVec>(i);
    sr[pad(j)] = r[i];
    sc[pad(j)] = c[i];
  }
}

// K0: whether to gather pairs (see the top of the file), and the pairs.
__global__ void __launch_bounds__(kThreads)
pattern_pairs_kernel(const int32_t* __restrict__ rows,
                     const int32_t* __restrict__ cols,
                     const int32_t* __restrict__ perm,
                     int2* __restrict__ pairs, long long L,
                     int* __restrict__ use_pairs, int vec, int force) {
  static_assert(kSample <= kThreads, "one sampled pair a thread");
  __shared__ int near_s;
  if (threadIdx.x == 0) near_s = 0;
  __syncthreads();
  if (force < 0 && threadIdx.x < kSample && L > 1) {
    const long long i = (long long)threadIdx.x * (L - 1) / kSample;
    const long long d = (long long)__ldg(perm + i + 1) - __ldg(perm + i);
    if (d < kNear && d > -kNear) atomicAdd(&near_s, 1);
  }
  __syncthreads();
  const int gather_pairs = force < 0 ? 2 * near_s < kSample : force;
  if (blockIdx.x == 0 && threadIdx.x == 0) *use_pairs = gather_pairs;
  if (!gather_pairs) return;
  const long long step = (long long)gridDim.x * kThreads;
  const long long g = (long long)blockIdx.x * kThreads + threadIdx.x;
  long long done = 0;
  if (vec) {  // 4 positions a step: two 16 B loads, two 16 B stores
    const long long n4 = L / 4;
    const int4* rv = reinterpret_cast<const int4*>(rows);
    const int4* cv = reinterpret_cast<const int4*>(cols);
    int4* pv = reinterpret_cast<int4*>(pairs);
    for (long long q = g; q < n4; q += step) {
      const int4 a = __ldcs(rv + q), b = __ldcs(cv + q);
      pv[2 * q] = make_int4(a.x, b.x, a.y, b.y);
      pv[2 * q + 1] = make_int4(a.z, b.z, a.w, b.w);
    }
    done = 4 * n4;
  }
  for (long long i = done + g; i < L; i += step)
    pairs[i] = make_int2(__ldcs(rows + i), __ldcs(cols + i));
}

template <bool kGather>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
pattern_build_kernel(Keys<kGather> keys, int32_t* __restrict__ srows,
                     int32_t* __restrict__ scols, int32_t* __restrict__ slot,
                     int32_t* __restrict__ indices,
                     int32_t* __restrict__ indptr, long long L, int M, int N,
                     long long nzmax, int* __restrict__ ticket,
                     int* __restrict__ total,
                     const int* __restrict__ use_pairs, DescI32 desc,
                     int vec) {
  __shared__ int32_t sr[kPadded], sc[kPadded], ss[kPadded], su[kTile];
  __shared__ int warp_n[kWarps];
  __shared__ int look[kLookWindows][32];
  __shared__ int tile_s, excl_s, prev_r, prev_c;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  if (t == 0) tile_s = atomicAdd(ticket, 1);  // the order of the chain
  __syncthreads();
  const int id = tile_s;
  const long long t0 = (long long)id * kTile;
  const bool full = vec && t0 + kTile <= L;
  if (kGather) keys.use_pairs = *use_pairs;  // K0's choice

  // -- 1. load: the key before the tile, then the tile's keys ------------
  if (t == 0 && t0 > 0) {
    int32_t r, c;
    keys.at(t0 - 1, r, c);
    prev_r = r;
    prev_c = c;
  }
  if (full)
    load_keys<kGather, true>(keys, srows, scols, t0, L, sr, sc);
  else
    load_keys<kGather, false>(keys, srows, scols, t0, L, sr, sc);
  __syncthreads();

  // -- 2. flags of the thread's kPer positions, and their count ----------
  const int b = t * kPer;
  int rp = 0, cp = 0;
  if (t > 0) {
    rp = sr[pad(b - 1)];
    cp = sc[pad(b - 1)];
  } else if (t0 > 0) {
    rp = prev_r;
    cp = prev_c;
  }
  const int c_before = cp;  // the column before the thread's first position
  unsigned flags = 0;
  int n = 0;
  {
    int r0 = rp, c0 = cp;
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      const long long pos = t0 + b + k;
      const int r = sr[pad(b + k)], c = sc[pad(b + k)];
      const bool f =
          pos < L && r < M && (pos == 0 || r != r0 || c != c0);
      flags |= (unsigned)f << k;
      n += f;
      r0 = r;
      c0 = c;
    }
  }
  int incl = n;  // inclusive scan of the counts over the warp
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, incl, d);
    if (lane >= d) incl += y;
  }
  if (lane == 31) warp_n[warp] = incl;
  __syncthreads();
  int before = 0, agg = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    const int y = warp_n[w];
    if (w < warp) before += y;
    agg += y;
  }

  // -- 3. carry across tiles: the uniques before the tile ----------------
  if (warp == 0) {
    if (id == 0) {
      if (lane == 0) {
        desc.publish(0, kPrefix, agg);
        excl_s = 0;
      }
    } else {
      if (lane == 0) desc.publish(id, kAggregate, agg);
      int e;
      look_back<CountOp>(desc, id, look, e);
      if (lane == 0) {
        desc.publish(id, kPrefix, e + agg);
        excl_s = e;
      }
    }
  }
  __syncthreads();
  const int E = excl_s;
  if (t == 0 && t0 + kTile >= L) *total = E + agg;  // the last tile

  // -- 4. slots, the compacted uniques and the column pointers -----------
  {
    int run = E + before + (incl - n);  // uniques before position b
    int c0 = c_before;
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      const long long pos = t0 + b + k;
      const int r = sr[pad(b + k)], c = sc[pad(b + k)];
      const int f = (flags >> k) & 1;
      run += f;
      ss[pad(b + k)] = r < M ? run - 1 : (int)nzmax;
      if (f) su[run - 1 - E] = r;
      // at a column change, indptr[j] for j in (c0, c], clipped to [0, N]
      long long lo = pos == 0 ? 0 : (long long)c0 + 1;
      if (lo < 0) lo = 0;
      const long long hi =
          pos < L && (pos == 0 || c != c0) ? (c < N ? c : N) : lo - 1;
      const int v = run - f;
      const bool wide = hi - lo >= kWideGap;
      if (!wide)
        for (long long j = lo; j <= hi; ++j) indptr[j] = v;
      // a wide gap of empty columns: the warp writes it, lane by lane
      for (unsigned todo = __ballot_sync(0xffffffffu, wide); todo;
           todo &= todo - 1) {
        const int src = __ffs(todo) - 1;
        const long long a = __shfl_sync(0xffffffffu, lo, src);
        const long long z = __shfl_sync(0xffffffffu, hi, src);
        const int w = __shfl_sync(0xffffffffu, v, src);
        for (long long j = a + lane; j <= z; j += 32) indptr[j] = w;
      }
      c0 = c;
    }
  }
  __syncthreads();

  // -- 5. store: slots as 16 B vectors, the tile's uniques in one stretch -
  if (full && ((uintptr_t)slot & 15) == 0) {
#pragma unroll
    for (int q = 0; q < kPer / 4; ++q) {
      const int o = q * kThreads + t, j = 4 * o;
      __stcs(reinterpret_cast<int4*>(slot + t0) + o,
             make_int4(ss[pad(j)], ss[pad(j + 1)], ss[pad(j + 2)],
                       ss[pad(j + 3)]));
    }
  } else {
#pragma unroll
    for (int q = 0; q < kPer; ++q) {
      const int j = q * kThreads + t;
      if (t0 + j < L) slot[t0 + j] = ss[pad(j)];
    }
  }
  for (int j = t; j < agg && (long long)E + j < nzmax; j += kThreads)
    indices[E + j] = su[j];
}

// K2: the sentinel tail of indices, the pointers past the last column and
// nnz, from the total the last tile wrote and the last sorted column.
__global__ void __launch_bounds__(kTailThreads)
pattern_tail_kernel(const int* __restrict__ total,
                    const int32_t* __restrict__ c_last,
                    int32_t* __restrict__ indices,
                    int32_t* __restrict__ indptr, int32_t* __restrict__ nnz,
                    long long nzmax, int M, int N) {
  const int tot = *total;
  const int cl = *c_last;
  const long long step = (long long)gridDim.x * kTailThreads;
  const long long g = (long long)blockIdx.x * kTailThreads + threadIdx.x;
  // indices[tot:nzmax] = M: single words up to a multiple of 4, 16 B
  // vectors (the wrapper's indices is 16 B aligned), single words after
  long long a = (tot + 3) & ~3LL;
  if (a > nzmax) a = nzmax;
  if (g < a - tot) indices[tot + g] = M;
  const long long n4 = (nzmax - a) / 4;
  int4* v = reinterpret_cast<int4*>(indices + a);
  for (long long q = g; q < n4; q += step) v[q] = make_int4(M, M, M, M);
  if (g < nzmax - (a + 4 * n4)) indices[a + 4 * n4 + g] = M;
  const long long j0 = cl < 0 ? 0 : (long long)cl + 1;
  for (long long j = j0 + g; j <= N; j += step) indptr[j] = tot;
  // with c_last >= N, K1 wrote indptr[N]
  if (g == 0) *nnz = cl < N ? tot : indptr[N];
}

// the tail grid: enough blocks to stream its writes, at most a few waves
constexpr long long kTailMaxBlocks = 132 * 8;

// K0's grid: a few waves of blocks, each striding over the stream
constexpr long long kPairBlocks = 132 * 8;

template <bool kGather>
int launch(const void* rows, const void* cols, const void* perm, void* pairs,
           void* srows, void* scols, void* slot, void* indices, void* indptr,
           void* nnz, void* scratch, long long L, int M, int N,
           long long nzmax, int force, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const long long ntiles = (L + kTile - 1) / kTile;
  unsigned long long* w = (unsigned long long*)scratch;
  const uintptr_t bits =
      (uintptr_t)rows | (uintptr_t)cols |
      (kGather ? ((uintptr_t)perm | (uintptr_t)srows | (uintptr_t)scols |
                  (uintptr_t)pairs)
               : 0);
  const int vec = (bits & 15) == 0;
  // the ticket in word 0, the total in word 1, K0's choice in word 2, the
  // descriptors after them
  int* use_pairs = (int*)(w + 2);
  int rc = 0;
  if (kGather) {
    long long blocks = (L + 4LL * kThreads - 1) / (4LL * kThreads);
    if (blocks > kPairBlocks) blocks = kPairBlocks;
    pattern_pairs_kernel<<<(unsigned)blocks, kThreads, 0, s>>>(
        (const int32_t*)rows, (const int32_t*)cols, (const int32_t*)perm,
        (int2*)pairs, L, use_pairs, vec, force);
    rc = (int)cudaGetLastError();
    if (rc) return rc;
  }
  pattern_build_kernel<kGather><<<(unsigned)ntiles, kThreads, 0, s>>>(
      Keys<kGather>{(const int32_t*)rows, (const int32_t*)cols,
                    (const int32_t*)perm, (const int2*)pairs, false},
      (int32_t*)srows, (int32_t*)scols, (int32_t*)slot, (int32_t*)indices,
      (int32_t*)indptr, L, M, N, nzmax, (int*)w, (int*)(w + 1), use_pairs,
      DescI32{w + 3}, vec);
  rc = (int)cudaGetLastError();
  if (rc) return rc;
  const long long span = nzmax > (long long)N + 1 ? nzmax : (long long)N + 1;
  long long blocks = (span + 4LL * kTailThreads - 1) / (4LL * kTailThreads);
  if (blocks > kTailMaxBlocks) blocks = kTailMaxBlocks;
  if (blocks < 1) blocks = 1;
  const int32_t* c_last =
      (const int32_t*)(kGather ? scols : cols) + (L - 1);
  pattern_tail_kernel<<<(unsigned)blocks, kTailThreads, 0, s>>>(
      (const int*)(w + 1), c_last, (int32_t*)indices, (int32_t*)indptr,
      (int32_t*)nnz, nzmax, M, N);
  return (int)cudaGetLastError();
}

}  // namespace

// The gathered entry: keys rows[perm], cols[perm], written to srows and
// scols.  pairs: 2L int32 of workspace (K0's).  scratch: 3 + ceil(L /
// pattern_tile()) zeroed 64-bit words; K0 leaves its choice (1: pairs) in
// word 2.  force: -1 lets K0 choose, 0 or 1 imposes the choice (tests).
extern "C" int pattern_from_perm_launch(const void* rows, const void* cols,
                                        const void* perm, void* pairs,
                                        void* srows, void* scols, void* slot,
                                        void* indices, void* indptr,
                                        void* nnz, void* scratch,
                                        long long L, int M, int N,
                                        long long nzmax, int force,
                                        void* stream) {
  return launch<true>(rows, cols, perm, pairs, srows, scols, slot, indices,
                      indptr, nnz, scratch, L, M, N, nzmax, force, stream);
}

// The presorted entry: keys r_s, c_s as they are.  scratch as above.
extern "C" int pattern_from_sorted_launch(const void* r_s, const void* c_s,
                                          void* slot, void* indices,
                                          void* indptr, void* nnz,
                                          void* scratch, long long L, int M,
                                          int N, long long nzmax,
                                          void* stream) {
  return launch<false>(r_s, c_s, nullptr, nullptr, nullptr, nullptr, slot,
                       indices, indptr, nnz, scratch, L, M, N, nzmax, -1,
                       stream);
}

extern "C" int pattern_tile(void) { return kTile; }

namespace {
const KernelResource kResources[] = {
    {"pattern_build_gather", (const void*)pattern_build_kernel<true>,
     kThreads, 0},
    {"pattern_build_sorted", (const void*)pattern_build_kernel<false>,
     kThreads, 0},
    {"pattern_tail", (const void*)pattern_tail_kernel, kTailThreads, 0},
    {"pattern_pairs", (const void*)pattern_pairs_kernel, kThreads, 0},
};
}  // namespace
REPRO_RESOURCE_TABLE(kResources)
