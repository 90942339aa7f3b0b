// The numeric phase's kernels: B3' (fused segment sum), B4 (fused
// segment min/max), B5 (inclusive prefix sum) and B6 (the SpGEMM
// numeric phase: fused two-gather product segment sum).
//
// B3' replaces repro/kernels/segment_sum/segment_sum.py:gather_masked_cumsum
// (_gather_cumsum_kernel) together with its _segment_totals epilogue
// (repro/kernels/segment_sum/ops.py): out[s] = sum of vals[perm[j]] over
// the sorted positions j with slot[j] == s, for every s < nzmax.  B4
// replaces gather_masked_segscan (_gather_segscan_kernel) together with
// the segment-end gather of gather_segment_reduce_sorted: out[s] is the
// min (or max) of the same values.  The compare propagates NaN as
// jnp.minimum/jnp.maximum do (fminf/fmaxf would drop it), and a fold
// starts from the identity +inf (min) or -inf (max), as accum_identity
// does.  Slots < 0 or >= nzmax are dropped wherever they fall; the
// caller's zeros stand in every empty slot.  Contract: every kept slot
// is one run of adjacent positions.
//
// What bounds them on the H100: bytes.  They read slot and perm once
// (8L B), gather each kept value once (4L B in float32) and write one
// value a kept slot (4 nzmax B): 12L + 4 nzmax B, one add (or compare)
// an element.  Where perm is random (a randomly ordered input) each
// value costs a 32-byte sector, from HBM once vals outgrows the 50 MB
// L2, so no design that gathers beats (8L + 32L + 4 nzmax) B at 3.35
// TB/s, nor the gather alone (the gather floor of
// segment_sum_probe.cu, timed by kernel_times.py and chip_smoke.py).
//
// The design is Merrill and Garland's single-pass segmented reduction:
// one launch, on B5's ticketed tiles and decoupled look-back (shared with
// B9 in lookback.cuh).  A tile is 256 threads x K (kSegPer = 8) sorted
// positions.
//  1. Load, striped: each thread reads its share of slot and perm, as
//     16 B vectors where both are aligned, streaming (__ldcs, evict
//     first: the one-touch index streams should not push the value
//     vector out of the L2), then issues its K gathers of vals before it
//     uses any, so K random loads are in flight a thread.  The slots and
//     the gathered values (the identity at a dropped slot) go to shared
//     memory, padded as in B5.  What a position's term is comes from the
//     kernel's value source (Gather here, Gather2 for B6); steps 2-4 do
//     not depend on it.
//  2. Reduce inside the tile: each thread folds K consecutive positions
//     run by run (a run is a maximal stretch of equal slots).  The
//     thread descriptors (has a run start; the partial of the run open
//     at its end) go through a segmented warp scan (shuffles) and a pass
//     across the 8 warps, under (f1, v1) o (f2, v2) = (f1 | f2, f2 ? v2 :
//     v1 + v2).
//  3. Carry across tiles: a tile that holds a run start publishes its
//     inclusive prefix at once (the run open at its end started inside
//     it); a tile inside one run publishes its aggregate.  A tile whose
//     first position continues a run looks back, warp 0 reading 32
//     descriptors a window, to the nearest prefix and folds the
//     aggregates after it left to right.  Chains are as long as the runs
//     that cross tiles, and a run of any length is reduced by all the
//     tiles it spans, never by one thread or one warp.
//  4. Write: each position that ends a kept run (the next slot differs)
//     stores out[slot], striped, so a warp's stores of consecutive slots
//     coalesce.
// Every order above is fixed by the tile ids; a tile's prefix is P(t) =
// a(t) if it holds a run start, else P(t - 1) + a(t), whichever prefix
// the look-back met, so the result is bit-identical from call to call.
//
// Order of additions, and its bound (B3').  A term reaches its slot's
// total through at most K - 1 additions in its thread, 5 in the warp
// scan, 6 in the fold of the warps before it and 1 joining that to the
// lanes before it (or 7 in the fold of an earlier tile's aggregate), and
// one rounding of the carried total to the data's type: K + 12
// roundings, each of at most u = eps / 2 of a partial.  The carry across
// tiles chains in double for float32 data and as a compensated pair for
// float64 (Chain, as in B5), which adds an error of order eps^2 at any
// run length.  So each total is
// within (K + 12) u sum|terms| = 10 eps sum|terms| of the exact sum to
// first order (K = 8), however long its run; the tests hold the kernel
// to C_SEG = 16 eps sum|terms| per slot (any K <= 20).  On
// integer-valued data below 2^24 (2^53 in float64) every sum is exact.
// Min and max are exact and do not depend on order: B4 is bit-identical
// to its plain version.
//
// B5 replaces repro/kernels/segment_sum/segment_sum.py:blocked_cumsum
// (_cumsum_kernel): the inclusive prefix sum of x.  The TPU kernel
// carries a running total across grid steps that run in order; blocks on
// the card run in no order.  What bounds it on the H100: bytes, x read
// once and out written once, 8L B in float32 (16L in float64); one add
// per element.
//
// This design is Merrill and Garland's single-pass scan with decoupled
// look-back, in one launch.  A tile is 256 threads x 16 values (4,096
// float32 or float64), loaded and stored as 16 B vectors and transposed
// through padded shared memory.  Each thread scans its values in
// registers, the block scans the thread totals with shuffles, and the
// tile publishes its aggregate at once.  Warp 0 then reads the
// descriptors of the tiles before it, 32 at a time (status: not yet /
// aggregate / inclusive prefix), spinning on the ones not yet
// published, until it meets an inclusive prefix; lane 0 folds the
// aggregates onto it left to right, the tile publishes its own
// inclusive prefix and adds the exclusive one to its values.  The fold
// makes every prefix P(t) = P(t-1) + a(t) whatever the timing, so the
// result is bit-identical from call to call.  Tiles take their ids from
// an atomic ticket (zeroed by the wrapper per call), so every tile a
// look-back waits on has already started: no deadlock.
//
// Order of additions, and its bound.  Inside a tile: a sequential sum
// over the thread's 16 values, a shuffle tree of depth 5, and up to 8
// warp totals in sequence.  Across tiles the prefixes chain through one
// addition a tile, which in the data's precision would give an output
// of tile t a worst-case error of order t eps (running sum of |x|); so
// the chain is carried in double for float32 data and as a compensated
// pair for float64 (Chain below), and adds an error of order eps^2.  The
// exclusive prefix is then rounded to the data's type once and added to
// the tile's values through one more addition.  To first order an output
// is within about (15 + 5 + 8 + 3) eps = 31 eps of the running sum of
// |x| from the exact prefix sum, at any L; the tests hold the kernel to
// 64 eps of it against its plain version.  On integer-valued data below
// 2^24 (2^53 in float64) every sum is exact.
//
// B6 replaces repro/kernels/segment_sum/segment_sum.py:gather2_masked_cumsum
// (_gather2_cumsum_kernel) together with its _segment_totals epilogue
// (repro/kernels/segment_sum/ops.py:gather2_segment_sum_sorted): out[s] is the
// sum of va[sa[j]] * vb[sb[j]] over the sorted product-stream positions j with
// slot[j] == s, for every s < nzmax.  The TPU kernel keeps both operand vectors
// resident in VMEM and carries a running prefix sum across in-order grid
// steps; here it is B3''s kernel with another value source (Gather2): three
// index streams read striped (16 B __ldcs vectors where slot, sa, sb and the
// tile start are aligned), all 2K gathers of a thread issued before any is
// used, each product rounded before it is added (no FMA contraction, as the
// plain version rounds it), and the same reduction, carry and striped write.
// A dropped slot contributes 0 and launches no gather.  Its tile depth and
// register bound (kSum2Per, kSum2MinBlocks) are B6's own, set by the timed
// sweep of segment_sum_probe.cu.  Bound: bytes, sa, sb and slot once (12F B),
// each operand value the streams reach once (4 |sa| + 4 |sb| B for the
// distinct sa and sb, gathered in 32 B sectors from L2 or HBM; an operand's
// padded tail is never read) and nzmax totals (4 nzmax B): 12F + 4 |sa| + 4
// |sb| + 4 nzmax B in all; one multiply and one add per product.  No design
// that gathers both operands beats the two-gather floor of the probe (B6's
// loads and products with the reduction removed).  Order of additions: as
// B3''s, on the rounded products, so each total is within (K + 12) u
// sum|terms| of the exact sum of the rounded products; and since a run of r
// terms meets r - 1 additions (a tree of r leaves has r - 1 inner nodes, the
// rest add the identity) and one rounding of the carried total, within r u
// sum|terms| as well.  On integer-valued data below 2^24 (2^53 in float64)
// the totals are exact.  Contract: every kept slot is one run of adjacent
// positions; a product plan's streams meet it for nzmax equal to the plan's
// (its compaction gives dropped products slot == nzmax, whose runs are not
// adjacent, and nothing ever writes out[nzmax]).
#include <cstdint>
#include <cuda_runtime.h>
#include "resources.cuh"
#include <math_constants.h>

#include "lookback.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

// Shared-memory index of value j of a tile, padded by one value per
// 128 B, so both a thread's consecutive values and the vector stores of
// neighbouring threads fall in distinct banks.
template <typename T>
__device__ __forceinline__ int pad(int j) {
  return j + j / (128 / (int)sizeof(T));
}

// Products rounded before they are added: no FMA contraction.
__device__ __forceinline__ float mul_rn(float a, float b) {
  return __fmul_rn(a, b);
}
__device__ __forceinline__ double mul_rn(double a, double b) {
  return __dmul_rn(a, b);
}

// NaN-propagating selections: a NaN on either side wins.
template <typename T>
__device__ __forceinline__ T pick_min(T a, T b) {
  return (a < b || a != a) ? a : b;
}

template <typename T>
__device__ __forceinline__ T pick_max(T a, T b) {
  return (a > b || a != a) ? a : b;
}

// The min/max reduction of B4 on the look-back's carried type.
template <typename T, bool kMax>
struct MinMaxOp {
  using C = Chain<T>;
  using Acc = typename C::Acc;
  static __device__ T identity() {
    return kMax ? T(-CUDART_INF) : T(CUDART_INF);
  }
  static __device__ T op(T a, T b) {
    return kMax ? pick_max(a, b) : pick_min(a, b);
  }
  static __device__ Acc of(T a) { return C::of(a); }
  static __device__ Acc combine(Acc a, Acc b) {
    return C::of(op(C::lead(a), C::lead(b)));
  }
  static __device__ T value(Acc a) { return C::lead(a); }
};

// -- B3', B4, B6 ---------------------------------------------------------------
// positions a thread reduces; the tile is kThreads x kSegPer
constexpr int kSegPer = 8;
// resident tiles an SM should hold: 5 caps float32 at 48 registers (the
// compiler takes 56 unbounded, 4 tiles an SM, and the fill of the FEM
// matrix runs 7% slower; 6 tiles spill), 4 caps float64 at 64
template <typename T>
constexpr int kSegMinBlocks = sizeof(T) == 4 ? 5 : 4;
// B6's, from the probe's sweep on an H100 (K = 4, 8, 12; 1-8 tiles an
// SM; float32): K = 8 at 5 tiles an SM (48 registers, 12 bytes of spill
// loads) is within 2% of the fastest on both products of the Galerkin
// operator (K = 12 at 4 tiles) and the fastest on the arrow matrix's
// B' B and one long run, where K = 12 loses 2%; on runs of 1..10^4 it
// is 4-6% behind K = 8 at 4 tiles and 6-8% ahead of K = 12; the
// compiler takes 78 registers unbounded (3 tiles an SM), 20% slower.
// float64 at 3 tiles an SM (80 registers; not swept).
constexpr int kSum2Per = 8;
template <typename T>
constexpr int kSum2MinBlocks = sizeof(T) == 4 ? 5 : 3;

// The value sources of the fill kernels.  A source names its kIdx index
// streams (read striped as slot is), fetches a position's operands into
// registers and makes its term from them once every gather of the thread
// is in flight.  Gather: vals[perm[j]] (B3', B4).  Gather2: va[sa[j]] *
// vb[sb[j]], rounded (B6).
template <typename T>
struct Gather {
  static constexpr int kIdx = 1;
  const T* vals;
  const int32_t* perm;
  __host__ uintptr_t bits() const { return (uintptr_t)perm; }
  __device__ const int32_t* idx(int) const { return perm; }
  __device__ void fetch(const int32_t (&p)[1], T (&r)[1]) const {
    r[0] = __ldg(vals + p[0]);
  }
  static __device__ T term(const T (&r)[1]) { return r[0]; }
};

template <typename T>
struct Gather2 {
  static constexpr int kIdx = 2;
  const T* va;
  const T* vb;
  const int32_t* sa;
  const int32_t* sb;
  __host__ uintptr_t bits() const { return (uintptr_t)sa | (uintptr_t)sb; }
  __device__ const int32_t* idx(int n) const { return n ? sb : sa; }
  __device__ void fetch(const int32_t (&p)[2], T (&r)[2]) const {
    r[0] = __ldg(va + p[0]);
    r[1] = __ldg(vb + p[1]);
  }
  static __device__ T term(const T (&r)[2]) { return mul_rn(r[0], r[1]); }
};

// Loads of the one-touch index streams: streaming (evict first), or
// through the read-only cache (a variant the timing probe compares).
struct LdStream {
  static __device__ int32_t one(const int32_t* p) { return __ldcs(p); }
  static __device__ int4 four(const int4* p) { return __ldcs(p); }
};

struct LdCached {
  static __device__ int32_t one(const int32_t* p) { return __ldg(p); }
  static __device__ int4 four(const int4* p) { return __ldg(p); }
};

// Register i of a thread holds tile position seg_at(i): 16 B vectors
// striped across the threads, or single values striped.
template <bool kVec>
__device__ __forceinline__ int seg_at(int i) {
  return kVec ? 4 * ((i / 4) * kThreads + (int)threadIdx.x) + (i & 3)
              : i * kThreads + (int)threadIdx.x;
}

// Step 1: the tile's slots and their terms (the identity at a dropped
// slot, and slot -1 past L) into shared memory, striped.
template <typename T, typename Op, int K, typename Ld, bool kVec,
          typename Src>
__device__ __forceinline__ void seg_load(const Src& src,
                                         const int32_t* __restrict__ slot,
                                         long long t0, long long L,
                                         long long nzmax, int32_t* ss,
                                         T* vv) {
  constexpr int N = Src::kIdx;
  int32_t s[K], p[K][N];
  if (kVec) {
    const int4* sv = reinterpret_cast<const int4*>(slot + t0);
#pragma unroll
    for (int q = 0; q < K / 4; ++q) {
      const int4 a = Ld::four(sv + q * kThreads + threadIdx.x);
      s[4 * q] = a.x;
      s[4 * q + 1] = a.y;
      s[4 * q + 2] = a.z;
      s[4 * q + 3] = a.w;
#pragma unroll
      for (int n = 0; n < N; ++n) {
        const int4 b = Ld::four(reinterpret_cast<const int4*>(src.idx(n) +
                                                              t0) +
                                q * kThreads + threadIdx.x);
        p[4 * q][n] = b.x;
        p[4 * q + 1][n] = b.y;
        p[4 * q + 2][n] = b.z;
        p[4 * q + 3][n] = b.w;
      }
    }
  } else {
#pragma unroll
    for (int i = 0; i < K; ++i) {
      const long long pos = t0 + seg_at<false>(i);
      s[i] = pos < L ? Ld::one(slot + pos) : -1;
#pragma unroll
      for (int n = 0; n < N; ++n)
        p[i][n] = pos < L ? Ld::one(src.idx(n) + pos) : 0;
    }
  }
  T r[K][N];
#pragma unroll
  for (int i = 0; i < K; ++i)  // all K N gathers before any use
    if (s[i] >= 0 && s[i] < nzmax) src.fetch(p[i], r[i]);
#pragma unroll
  for (int i = 0; i < K; ++i) {
    const int j = seg_at<kVec>(i);
    ss[pad<int32_t>(j)] = s[i];
    vv[pad<T>(j)] =
        (s[i] >= 0 && s[i] < nzmax) ? Src::term(r[i]) : Op::identity();
  }
}

template <typename T, typename Op, int K, typename Ld, int kMinBlocks,
          typename Src, typename Desc>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
segment_reduce_kernel(Src src, const int32_t* __restrict__ slot,
                      T* __restrict__ out, long long L, long long nzmax,
                      int* __restrict__ ticket, Desc desc, int vec) {
  constexpr int kTile = kThreads * K;
  using Acc = typename Op::Acc;
  __shared__ int32_t ss[kTile + kTile / 32];
  __shared__ T vv[kTile + kTile / (128 / sizeof(T))];
  __shared__ int warp_f[kWarps];
  __shared__ T warp_v[kWarps];
  __shared__ Acc look[kLookWindows][32];
  __shared__ Acc excl_s;
  __shared__ int tile_s, prev_s, next_s, need_s;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  if (t == 0) tile_s = atomicAdd(ticket, 1);  // the order of the chain
  __syncthreads();
  const int id = tile_s;
  const long long t0 = (long long)id * kTile;

  // -- 1. load: the slots either side of the tile, then the tile ---------
  if (t == 0) prev_s = t0 > 0 ? Ld::one(slot + t0 - 1) : 0;
  if (t == kThreads - 1)
    next_s = t0 + kTile < L ? Ld::one(slot + t0 + kTile) : -1;
  if (vec && t0 + kTile <= L)
    seg_load<T, Op, K, Ld, true>(src, slot, t0, L, nzmax, ss, vv);
  else
    seg_load<T, Op, K, Ld, false>(src, slot, t0, L, nzmax, ss, vv);
  __syncthreads();

  // -- 2. reduce inside the tile -------------------------------------------
  // the thread's K positions, run by run; the partials wait in shared
  // memory.  `first` is the thread's first run start (K: none).
  const int b = t * K;
  int prev = t > 0 ? ss[pad<int32_t>(b - 1)] : prev_s;
  int first = K;
  T run = Op::identity();
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int s = ss[pad<int32_t>(b + k)];
    const T y = vv[pad<T>(b + k)];
    const bool head = s != prev || (k == 0 && t == 0 && t0 == 0);
    if (head && first == K) first = k;
    run = (head || k == 0) ? y : Op::op(run, y);
    vv[pad<T>(b + k)] = run;
    prev = s;
  }
  int f = first < K;
  T v = run;
  warp_segscan<Op>(f, v);
  int fx = __shfl_up_sync(0xffffffffu, f, 1);
  T vx = __shfl_up_sync(0xffffffffu, v, 1);
  if (lane == 0) {
    fx = 0;
    vx = Op::identity();
  }
  if (lane == 31) {
    warp_f[warp] = f;
    warp_v[warp] = v;
  }
  if (t == 0) need_s = first != 0;  // the tile continues a run
  __syncthreads();
  // the warps before this one, and the tile's aggregate
  int fb = 0, F = 0;
  T vb = Op::identity(), A = Op::identity();
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    const int fw = warp_f[w];
    const T yw = warp_v[w];
    if (w < warp) {
      vb = fw ? yw : Op::op(vb, yw);
      fb |= fw;
    }
    A = fw ? yw : Op::op(A, yw);
    F |= fw;
  }
  const int fe = fb | fx;                   // a run starts before the thread
  const T ce = fx ? vx : Op::op(vb, vx);    // the run open there

  // -- 3. carry across tiles: publish, and look back if a run comes in ---
  if (warp == 0) {
    if (lane == 0) desc.publish(id, F ? kPrefix : kAggregate, Op::of(A));
    if (need_s) {
      Acc e;
      look_back<Op>(desc, id, look, e);
      if (lane == 0) {
        if (!F) desc.publish(id, kPrefix, Op::combine(e, Op::of(A)));
        excl_s = e;
      }
    }
  }
  __syncthreads();
  if (first > 0) {  // the run the thread's first positions continue
    Acc carry = Op::of(ce);
    if (!fe) carry = Op::combine(excl_s, carry);
#pragma unroll
    for (int k = 0; k < K; ++k)
      if (k < first)
        vv[pad<T>(b + k)] =
            Op::value(Op::combine(carry, Op::of(vv[pad<T>(b + k)])));
  }
  __syncthreads();

  // -- 4. write each kept run's total at its last position, striped -------
#pragma unroll
  for (int q = 0; q < K; ++q) {
    const int j = q * kThreads + t;
    const int s = ss[pad<int32_t>(j)];
    if (s >= 0 && s < nzmax) {
      const int next = j + 1 < kTile ? ss[pad<int32_t>(j + 1)] : next_s;
      if (next != s) out[s] = vv[pad<T>(j)];
    }
  }
}

// -- B5 ---------------------------------------------------------------------
// A thread holds 16 values of a tile, loaded as 16 B vectors
// (neighbouring threads on neighbouring vectors) and transposed through
// shared memory padded by one value per 128 B (pad), so both the vector
// stores and each thread's consecutive values fall in distinct banks.
template <typename T>
struct ScanShape {
  static constexpr int kPer = 16;                // values per thread
  static constexpr int kTile = kThreads * kPer;  // values per tile
  static constexpr int kVec = 16 / sizeof(T);    // values per 16 B vector
  static constexpr int kLoads = kPer / kVec;     // vectors per thread
  static constexpr int kPadded = kTile + kTile / (128 / sizeof(T));
  // resident tiles an SM should hold: the scan is bound by the bytes its
  // resident tiles keep in flight (6 in float32 caps it at 40 registers,
  // the fastest of 5-8 on an H100; in float64 its 43 KB of shared memory
  // allow 5)
  static constexpr int kMinBlocks = sizeof(T) == 4 ? 6 : 5;
};

template <typename T>
__device__ __forceinline__ T warp_inclusive_scan(T x) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const T y = __shfl_up_sync(0xffffffffu, x, d);
    if (lane >= d) x += y;
  }
  return x;
}

template <typename T, typename Desc>
__global__ void __launch_bounds__(kThreads, ScanShape<T>::kMinBlocks)
scan_lookback_kernel(const T* __restrict__ x, T* __restrict__ out,
                     long long L, int* __restrict__ ticket, Desc desc,
                     int vec) {
  using S = ScanShape<T>;
  union Vec {
    uint4 u;
    T v[S::kVec];
  };
  __shared__ T tile[S::kPadded];
  __shared__ T warps[kThreads / 32];
  using C = Chain<T>;
  using Acc = typename C::Acc;
  __shared__ Acc look[kLookWindows][32];
  __shared__ T excl_s;
  __shared__ int tile_s;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  if (t == 0) tile_s = atomicAdd(ticket, 1);  // the order of the chain
  __syncthreads();
  const int id = tile_s;
  const long long t0 = (long long)id * S::kTile;
  const bool full = vec && t0 + S::kTile <= L;

  // -- load, 16 B vectors, and transpose --------------------------------
  if (full) {
    const uint4* xv = reinterpret_cast<const uint4*>(x + t0);
#pragma unroll
    for (int q = 0; q < S::kLoads; ++q) {
      Vec w;
      w.u = __ldcs(xv + q * kThreads + t);  // read once: stream
#pragma unroll
      for (int r = 0; r < S::kVec; ++r)
        tile[pad<T>((q * kThreads + t) * S::kVec + r)] = w.v[r];
    }
  } else {
#pragma unroll
    for (int q = 0; q < S::kPer; ++q) {
      const int j = q * kThreads + t;
      tile[pad<T>(j)] = t0 + j < L ? x[t0 + j] : T(0);
    }
  }
  __syncthreads();

  // -- the tile's own scan: registers, then shuffles ----------------------
  // the scanned values wait in shared memory through the look-back, so
  // few registers stay live and more tiles fit on an SM
  T run = T(0);
#pragma unroll
  for (int i = 0; i < S::kPer; ++i) {
    T& y = tile[pad<T>(t * S::kPer + i)];
    run += y;
    y = run;
  }
  const T incl = warp_inclusive_scan(run);
  T ex = __shfl_up_sync(0xffffffffu, incl, 1);
  if (lane == 0) ex = T(0);
  if (lane == 31) warps[warp] = incl;
  __syncthreads();
  T before = T(0), aggregate = T(0);
#pragma unroll
  for (int w = 0; w < kThreads / 32; ++w) {
    const T y = warps[w];
    if (w < warp) before += y;
    aggregate += y;
  }

  // -- decoupled look-back: warp 0 finds the tile's exclusive prefix -----
  if (warp == 0) {
    if (id == 0) {
      if (lane == 0) {
        desc.publish(0, kPrefix, C::of(aggregate));
        excl_s = T(0);
      }
    } else {
      if (lane == 0) desc.publish(id, kAggregate, C::of(aggregate));
      Acc excl;
      look_back<SumOp<T>>(desc, id, look, excl);
      if (lane == 0) {
        desc.publish(id, kPrefix, C::add(excl, C::of(aggregate)));
        excl_s = C::value(excl);
      }
    }
  }
  __syncthreads();

  // -- add, transpose back, store -----------------------------------------
  const T base = excl_s + (before + ex);
#pragma unroll
  for (int i = 0; i < S::kPer; ++i)
    tile[pad<T>(t * S::kPer + i)] += base;
  __syncthreads();
  if (full) {
    uint4* ov = reinterpret_cast<uint4*>(out + t0);
#pragma unroll
    for (int q = 0; q < S::kLoads; ++q) {
      Vec w;
#pragma unroll
      for (int r = 0; r < S::kVec; ++r)
        w.v[r] = tile[pad<T>((q * kThreads + t) * S::kVec + r)];
      __stcs(ov + q * kThreads + t, w.u);
    }
  } else {
#pragma unroll
    for (int q = 0; q < S::kPer; ++q) {
      const int j = q * kThreads + t;
      if (t0 + j < L) out[t0 + j] = tile[pad<T>(j)];
    }
  }
}

// scratch: 1 + 2 ntiles (float32) or 1 + 4 ntiles (float64) zeroed
// 64-bit words, ntiles = ceil(L / (kThreads * K)): the tile ticket, then
// the descriptors
template <typename T, typename Op, int K, typename Ld, int kMinBlocks,
          typename Src>
int launch_reduce(const Src& src, const void* slot, void* out, void* scratch,
                  long long L, long long nzmax, void* stream) {
  const long long ntiles = (L + kThreads * K - 1) / (kThreads * K);
  unsigned long long* w = (unsigned long long*)scratch;
  const int vec = ((src.bits() | (uintptr_t)slot) & 15) == 0;
  segment_reduce_kernel<T, Op, K, Ld, kMinBlocks>
      <<<(unsigned)ntiles, kThreads, 0, (cudaStream_t)stream>>>(
          src, (const int32_t*)slot, (T*)out, L, nzmax, (int*)w,
          DescOf<T>::at(w, ntiles), vec);
  return (int)cudaGetLastError();
}

template <typename T, typename Op, int K = kSegPer, typename Ld = LdStream,
          int kMinBlocks = kSegMinBlocks<T>>
int launch_segment(const void* vals, const void* perm, const void* slot,
                   void* out, void* scratch, long long L, long long nzmax,
                   void* stream) {
  return launch_reduce<T, Op, K, Ld, kMinBlocks>(
      Gather<T>{(const T*)vals, (const int32_t*)perm}, slot, out, scratch, L,
      nzmax, stream);
}

// scratch as launch_reduce's, at B6's tile
template <typename T, int K = kSum2Per, typename Ld = LdStream,
          int kMinBlocks = kSum2MinBlocks<T>>
int launch_sum2(const void* va, const void* vb, const void* sa,
                const void* sb, const void* slot, void* out, void* scratch,
                long long L, long long nzmax, void* stream) {
  return launch_reduce<T, SumOp<T>, K, Ld, kMinBlocks>(
      Gather2<T>{(const T*)va, (const T*)vb, (const int32_t*)sa,
                 (const int32_t*)sb},
      slot, out, scratch, L, nzmax, stream);
}

template <typename T>
int launch_minmax(const void* vals, const void* perm, const void* slot,
                  void* out, void* scratch, long long L, long long nzmax,
                  int is_max, void* stream) {
  return is_max ? launch_segment<T, MinMaxOp<T, true>>(
                      vals, perm, slot, out, scratch, L, nzmax, stream)
                : launch_segment<T, MinMaxOp<T, false>>(
                      vals, perm, slot, out, scratch, L, nzmax, stream);
}

// scratch as launch_segment's, ntiles = ceil(L / ScanShape<T>::kTile)
template <typename T>
int launch_cumsum(const void* x, void* out, void* scratch, long long L,
                  void* stream) {
  using S = ScanShape<T>;
  const long long ntiles = (L + S::kTile - 1) / S::kTile;
  unsigned long long* w = (unsigned long long*)scratch;
  const int vec = (((uintptr_t)x | (uintptr_t)out) & 15) == 0;
  scan_lookback_kernel<T><<<(unsigned)ntiles, kThreads, 0,
                            (cudaStream_t)stream>>>(
      (const T*)x, (T*)out, L, (int*)w, DescOf<T>::at(w, ntiles), vec);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int gather_segment_sum_f32_launch(const void* vals,
                                             const void* perm,
                                             const void* slot, void* out,
                                             void* scratch, long long L,
                                             long long nzmax, void* stream) {
  return launch_segment<float, SumOp<float>>(vals, perm, slot, out, scratch,
                                             L, nzmax, stream);
}

extern "C" int gather_segment_sum_f64_launch(const void* vals,
                                             const void* perm,
                                             const void* slot, void* out,
                                             void* scratch, long long L,
                                             long long nzmax, void* stream) {
  return launch_segment<double, SumOp<double>>(vals, perm, slot, out,
                                               scratch, L, nzmax, stream);
}

extern "C" int gather2_segment_sum_f32_launch(
    const void* va, const void* vb, const void* sa, const void* sb,
    const void* slot, void* out, void* scratch, long long L, long long nzmax,
    void* stream) {
  return launch_sum2<float>(va, vb, sa, sb, slot, out, scratch, L, nzmax,
                            stream);
}

extern "C" int gather2_segment_sum_f64_launch(
    const void* va, const void* vb, const void* sa, const void* sb,
    const void* slot, void* out, void* scratch, long long L, long long nzmax,
    void* stream) {
  return launch_sum2<double>(va, vb, sa, sb, slot, out, scratch, L, nzmax,
                             stream);
}

extern "C" int gather_segment_minmax_f32_launch(
    const void* vals, const void* perm, const void* slot, void* out,
    void* scratch, long long L, long long nzmax, int is_max, void* stream) {
  return launch_minmax<float>(vals, perm, slot, out, scratch, L, nzmax,
                              is_max, stream);
}

extern "C" int gather_segment_minmax_f64_launch(
    const void* vals, const void* perm, const void* slot, void* out,
    void* scratch, long long L, long long nzmax, int is_max, void* stream) {
  return launch_minmax<double>(vals, perm, slot, out, scratch, L, nzmax,
                               is_max, stream);
}

extern "C" int blocked_cumsum_f32_launch(const void* x, void* out,
                                         void* scratch, long long L,
                                         void* stream) {
  return launch_cumsum<float>(x, out, scratch, L, stream);
}

extern "C" int blocked_cumsum_f64_launch(const void* x, void* out,
                                         void* scratch, long long L,
                                         void* stream) {
  return launch_cumsum<double>(x, out, scratch, L, stream);
}

static_assert(ScanShape<float>::kTile == ScanShape<double>::kTile,
              "one tile size for both types");
extern "C" int scan_tile(void) { return ScanShape<float>::kTile; }
extern "C" int segment_tile(void) { return kThreads * kSegPer; }
extern "C" int product_tile(void) { return kThreads * kSum2Per; }

namespace {
template <typename T>
using DescT = decltype(DescOf<T>::at(nullptr, 0));
template <typename T, typename Op, int K, int kMinBlocks, typename Src>
inline const void* reduce_fn() {
  return (const void*)segment_reduce_kernel<T, Op, K, LdStream, kMinBlocks,
                                            Src, DescT<T>>;
}
const KernelResource kResources[] = {
    {"gather_segment_sum_f32",
     reduce_fn<float, SumOp<float>, kSegPer, kSegMinBlocks<float>,
               Gather<float>>(), kThreads, 0},
    {"gather_segment_sum_f64",
     reduce_fn<double, SumOp<double>, kSegPer, kSegMinBlocks<double>,
               Gather<double>>(), kThreads, 0},
    {"gather_segment_max_f32",
     reduce_fn<float, MinMaxOp<float, true>, kSegPer, kSegMinBlocks<float>,
               Gather<float>>(), kThreads, 0},
    {"gather_segment_max_f64",
     reduce_fn<double, MinMaxOp<double, true>, kSegPer,
               kSegMinBlocks<double>, Gather<double>>(), kThreads, 0},
    {"gather_segment_min_f32",
     reduce_fn<float, MinMaxOp<float, false>, kSegPer, kSegMinBlocks<float>,
               Gather<float>>(), kThreads, 0},
    {"gather_segment_min_f64",
     reduce_fn<double, MinMaxOp<double, false>, kSegPer,
               kSegMinBlocks<double>, Gather<double>>(), kThreads, 0},
    {"gather2_segment_sum_f32",
     reduce_fn<float, SumOp<float>, kSum2Per, kSum2MinBlocks<float>,
               Gather2<float>>(), kThreads, 0},
    {"gather2_segment_sum_f64",
     reduce_fn<double, SumOp<double>, kSum2Per, kSum2MinBlocks<double>,
               Gather2<double>>(), kThreads, 0},
    {"blocked_cumsum_f32",
     (const void*)scan_lookback_kernel<float, DescT<float>>, kThreads, 0},
    {"blocked_cumsum_f64",
     (const void*)scan_lookback_kernel<double, DescT<double>>, kThreads, 0},
};
}  // namespace
REPRO_RESOURCE_TABLE(kResources)
