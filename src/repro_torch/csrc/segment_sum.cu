// The numeric phase's kernels: B3' (fused segment sum), B4 (fused
// segment min/max), B5 (inclusive prefix sum) and B6 (the SpGEMM
// numeric phase: fused two-gather product segment sum).
//
// B3' replaces repro/kernels/segment_sum/segment_sum.py:gather_masked_cumsum
// (_gather_cumsum_kernel) together with its _segment_totals epilogue
// (repro/kernels/segment_sum/ops.py): out[s] = sum of vals[perm[j]] over
// the sorted positions j with slot[j] == s, for every s < nzmax.
//
// What bounds it on the H100: bytes.  It reads perm and slot once
// (8L B), gathers each value once (4L B in f32, at random addresses, so
// in 32 B sectors once vals outgrows the 50 MB L2) and writes nzmax sums.
// There is one add per element.
//
// What the simple design does about it: one thread per sorted position.
// The thread at the start of a kept segment (slot[i] < nzmax and
// slot[i] != slot[i-1]) walks its segment in sorted order and writes the
// total once: no atomics, no carry between blocks, a deterministic sum
// order, and no global running total (a float32 running sum past 2^24
// would drop low bits from every later segment, which the TPU kernel's
// cumsum-and-difference pays).  Every slot >= nzmax is dropped, so a
// capacity below nnz truncates exactly as the reference's mode="drop".
// Known limit: a long run of duplicates serialises on one thread (runs
// are 1-10 long on the paper's data sets).
//
// B4 replaces repro/kernels/segment_sum/segment_sum.py:gather_masked_segscan
// (_gather_segscan_kernel) together with the segment-end gather of
// gather_segment_reduce_sorted (repro/kernels/segment_sum/ops.py): out[s]
// is the min (or max) of vals[perm[j]] over the kept positions j with
// slot[j] == s; the caller's zeros stand in every empty slot.  The TPU
// kernel's Hillis-Steele ladder and its carry across in-order grid steps
// have no use here: the op's result is computed directly, on B3''s
// design (one thread walks each segment), with the same bound (12L B
// plus 4 nzmax B, one compare per element).  Min/max is exact and does
// not depend on order, so the result is bit-identical to the plain
// version.  The compare propagates NaN as jnp.minimum/jnp.maximum do
// (fminf/fmaxf would drop it), and the fold starts from the identity
// +inf (min) or -inf (max), as accum_identity does.
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
// (repro/kernels/segment_sum/ops.py:gather2_segment_sum_sorted): out[s] is
// the sum of va[sa[j]] * vb[sb[j]] over the sorted product-stream positions
// j with slot[j] == s, for every s < nzmax.  The TPU kernel keeps both
// operand vectors resident in VMEM and carries a running prefix sum across
// in-order grid steps; here it is B3''s design with two gathers: the thread
// at the start of a kept run walks it and writes the total once (no
// carry, no atomics, deterministic order, no float32 running total past
// 2^24).  Each product is rounded before the add (no FMA contraction), as
// the plain version rounds it.  Bound: bytes, sa, sb and slot once (12F B),
// each operand value the streams reach once (4 |sa| + 4 |sb| B for the
// distinct sa and sb, gathered in 32 B sectors from L2 or HBM; an
// operand's padded tail is never read) and nzmax totals (4 nzmax B): 12F +
// 4 |sa| + 4 |sb| + 4 nzmax B in all; one multiply and one add per
// product.  Contract: every kept slot is one run of adjacent positions;
// a product plan's streams meet it for nzmax equal to the plan's (its
// compaction gives dropped products slot == nzmax, whose runs are not
// adjacent, and nothing ever writes out[nzmax]).
#include <cstdint>
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kThreads = 256;

template <typename T>
__global__ void __launch_bounds__(kThreads)
gather_segment_sum_kernel(const T* __restrict__ vals,
                          const int32_t* __restrict__ perm,
                          const int32_t* __restrict__ slot,
                          T* __restrict__ out, long long L, long long nzmax) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= L) return;
  const int s = __ldg(slot + i);
  if (s < 0 || s >= nzmax) return;              // padding / over capacity
  if (i > 0 && __ldg(slot + i - 1) == s) return;  // not a segment start
  T acc = T(0);
  for (long long j = i; j < L && __ldg(slot + j) == s; ++j)
    acc += __ldg(vals + __ldg(perm + j));
  out[s] = acc;
}

// Products rounded before they are added: no FMA contraction.
__device__ __forceinline__ float mul_rn(float a, float b) {
  return __fmul_rn(a, b);
}
__device__ __forceinline__ double mul_rn(double a, double b) {
  return __dmul_rn(a, b);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
gather2_segment_sum_kernel(const T* __restrict__ va, const T* __restrict__ vb,
                           const int32_t* __restrict__ sa,
                           const int32_t* __restrict__ sb,
                           const int32_t* __restrict__ slot,
                           T* __restrict__ out, long long L, long long nzmax) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= L) return;
  const int s = __ldg(slot + i);
  if (s < 0 || s >= nzmax) return;              // padding / dropped
  if (i > 0 && __ldg(slot + i - 1) == s) return;  // not a run start
  T acc = T(0);
  for (long long j = i; j < L && __ldg(slot + j) == s; ++j)
    acc += mul_rn(__ldg(va + __ldg(sa + j)), __ldg(vb + __ldg(sb + j)));
  out[s] = acc;
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

template <typename T, bool kMax>
__global__ void __launch_bounds__(kThreads)
gather_segment_minmax_kernel(const T* __restrict__ vals,
                             const int32_t* __restrict__ perm,
                             const int32_t* __restrict__ slot,
                             T* __restrict__ out, long long L,
                             long long nzmax) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= L) return;
  const int s = __ldg(slot + i);
  if (s < 0 || s >= nzmax) return;
  if (i > 0 && __ldg(slot + i - 1) == s) return;
  T acc = kMax ? T(-CUDART_INF) : T(CUDART_INF);
  for (long long j = i; j < L && __ldg(slot + j) == s; ++j) {
    const T v = __ldg(vals + __ldg(perm + j));
    acc = kMax ? pick_max(acc, v) : pick_min(acc, v);
  }
  out[s] = acc;
}

// -- B5 ---------------------------------------------------------------------
// A thread holds 16 values of a tile, loaded as 16 B vectors
// (neighbouring threads on neighbouring vectors) and transposed through
// shared memory padded by one value per 128 B, so both the vector stores
// and each thread's consecutive values fall in distinct banks.
template <typename T>
struct ScanShape {
  static constexpr int kPer = 16;                // values per thread
  static constexpr int kTile = kThreads * kPer;  // values per tile
  static constexpr int kVec = 16 / sizeof(T);    // values per 16 B vector
  static constexpr int kLoads = kPer / kVec;     // vectors per thread
  static constexpr int kRow = 128 / sizeof(T);   // values per padding step
  static constexpr int kPadded = kTile + kTile / kRow;
  // resident tiles an SM should hold: the scan is bound by the bytes its
  // resident tiles keep in flight (6 in float32 caps it at 40 registers,
  // the fastest of 5-8 on an H100; in float64 its 43 KB of shared memory
  // allow 5)
  static constexpr int kMinBlocks = sizeof(T) == 4 ? 6 : 5;
};

template <typename T>
__device__ __forceinline__ int scan_pad(int j) {
  return j + j / ScanShape<T>::kRow;
}

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

__device__ __forceinline__ int ld_acquire_s32(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.s32 %0, [%1];"
               : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void st_release_s32(int* p, int v) {
  asm volatile("st.release.gpu.global.s32 [%0], %1;"
               :: "l"(p), "r"(v) : "memory");
}

// A tile's descriptor: status 0 (not yet), kAggregate (its own sum) or
// kPrefix (the inclusive prefix through it), and the value.
constexpr int kAggregate = 1, kPrefix = 2;
// the look-back reads 32 descriptors a window, one a lane, and keeps up
// to kLookWindows windows of them
constexpr int kLookWindows = 8;

// The tiles' prefixes chain through one addition a tile, so they are
// carried with more precision than the data: in double for float32
// data, as a compensated pair (hi + lo, TwoSum) for float64.  A chain
// step P(t) = P(t-1) + a(t) then adds an error of order eps^2 P, not
// eps P.
template <typename T>
struct Chain;

template <>
struct Chain<float> {
  using Acc = double;
  static __device__ Acc of(float a) { return a; }
  static __device__ Acc add(Acc p, Acc a) { return p + a; }
  static __device__ float value(Acc p) { return (float)p; }
};

template <>
struct Chain<double> {
  struct Acc {
    double hi, lo;
  };
  static __device__ Acc of(double a) { return {a, 0.0}; }
  static __device__ Acc add(Acc p, Acc a) {
    const double s = p.hi + a.hi, v = s - p.hi;
    const double err = (p.hi - (s - v)) + (a.hi - v);  // s + err == p.hi + a.hi
    return {s, p.lo + a.lo + err};
  }
  static __device__ double value(Acc p) { return p.hi + p.lo; }
};

// float32: an aggregate word and a prefix word a tile, each one atomic
// 64-bit load or store of the double value XOR kEmpty, so that the
// zeroed word reads as not yet: no arithmetic result has kEmpty's bits
// (a signalling NaN; NaNs computed on the card are quiet).
struct DescF32 {
  static constexpr unsigned long long kEmpty = 0x7ff4000000000001ull;
  unsigned long long* aggregate;
  unsigned long long* prefix;
  __device__ void publish(int tile, int status, double v) const {
    const unsigned long long w =
        (unsigned long long)__double_as_longlong(v) ^ kEmpty;
    asm volatile("st.relaxed.gpu.global.u64 [%0], %1;"
                 :: "l"((status == kAggregate ? aggregate : prefix) + tile),
                    "l"(w) : "memory");
  }
  __device__ int read(int tile, double& v) const {
    unsigned long long a, p;
    asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];"
                 : "=l"(p) : "l"(prefix + tile) : "memory");
    asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];"
                 : "=l"(a) : "l"(aggregate + tile) : "memory");
    const unsigned long long w = p ? p : a;
    v = __longlong_as_double((long long)(w ^ kEmpty));
    return p ? kPrefix : a ? kAggregate : 0;
  }
};

// float64: a 16-byte store is not guaranteed atomic, so the status is a
// flag of its own, stored with release after the value and loaded with
// acquire before it.  The aggregate and the prefix (hi, lo) have slots of
// their own and none is ever overwritten, so a reader that saw
// kAggregate reads the aggregate even if the tile has since moved on to
// kPrefix.
struct DescF64 {
  using Acc = Chain<double>::Acc;
  int* status;
  double* aggregate;
  double* hi;
  double* lo;
  __device__ void publish(int tile, int s, Acc v) const {
    if (s == kAggregate) {
      __stcg(aggregate + tile, v.hi);
    } else {
      __stcg(hi + tile, v.hi);
      __stcg(lo + tile, v.lo);
    }
    st_release_s32(status + tile, s);
  }
  __device__ int read(int tile, Acc& v) const {
    const int s = ld_acquire_s32(status + tile);
    if (s == kAggregate) v = {__ldcg(aggregate + tile), 0.0};
    if (s == kPrefix) v = {__ldcg(hi + tile), __ldcg(lo + tile)};
    return s;
  }
};

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
        tile[scan_pad<T>((q * kThreads + t) * S::kVec + r)] = w.v[r];
    }
  } else {
#pragma unroll
    for (int q = 0; q < S::kPer; ++q) {
      const int j = q * kThreads + t;
      tile[scan_pad<T>(j)] = t0 + j < L ? x[t0 + j] : T(0);
    }
  }
  __syncthreads();

  // -- the tile's own scan: registers, then shuffles ----------------------
  // the scanned values wait in shared memory through the look-back, so
  // few registers stay live and more tiles fit on an SM
  T run = T(0);
#pragma unroll
  for (int i = 0; i < S::kPer; ++i) {
    T& y = tile[scan_pad<T>(t * S::kPer + i)];
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
  // It reads 32 descriptors a window, one a lane, nearest first, keeping
  // the values in `look`, until a window holds a prefix; past
  // kLookWindows windows it reads the last one again until one appears.
  // Then lane 0 folds left to right from the nearest prefix P(s) through
  // the aggregates a(s+1) .. a(id-1).  Every P(t) is thus P(t-1) + a(t),
  // whichever prefix the look-back met: the result does not depend on
  // timing.
  if (warp == 0) {
    if (id == 0) {
      if (lane == 0) {
        desc.publish(0, kPrefix, C::of(aggregate));
        excl_s = T(0);
      }
    } else {
      if (lane == 0) desc.publish(id, kAggregate, C::of(aggregate));
      int w = 0, stop = 0;
      while (true) {
        const int pred = id - 1 - w * 32 - lane;  // this lane's descriptor
        Acc val = C::of(T(0));
        int st = kPrefix;  // before tile 0: never met, tile 0 is a prefix
        if (pred >= 0) {
          st = desc.read(pred, val);
          while (st == 0) st = desc.read(pred, val);
        }
        look[w][lane] = val;
        const int first =
            __reduce_min_sync(0xffffffffu, st == kPrefix ? lane : 32);
        if (first < 32) {
          stop = first;
          break;
        }
        if (w + 1 < kLookWindows) ++w;
      }
      __syncwarp();
      if (lane == 0) {
        // only the aggregates after the prefix: each add waits on the last
        Acc excl = look[w][stop];
        for (int q = stop - 1; q >= 0; --q) excl = C::add(excl, look[w][q]);
        for (int u = w - 1; u >= 0; --u)
          for (int q = 31; q >= 0; --q) excl = C::add(excl, look[u][q]);
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
    tile[scan_pad<T>(t * S::kPer + i)] += base;
  __syncthreads();
  if (full) {
    uint4* ov = reinterpret_cast<uint4*>(out + t0);
#pragma unroll
    for (int q = 0; q < S::kLoads; ++q) {
      Vec w;
#pragma unroll
      for (int r = 0; r < S::kVec; ++r)
        w.v[r] = tile[scan_pad<T>((q * kThreads + t) * S::kVec + r)];
      __stcs(ov + q * kThreads + t, w.u);
    }
  } else {
#pragma unroll
    for (int q = 0; q < S::kPer; ++q) {
      const int j = q * kThreads + t;
      if (t0 + j < L) out[t0 + j] = tile[scan_pad<T>(j)];
    }
  }
}

template <typename T>
int launch_sum(const void* vals, const void* perm, const void* slot,
               void* out, long long L, long long nzmax, void* stream) {
  const long long blocks = (L + kThreads - 1) / kThreads;
  gather_segment_sum_kernel<T><<<(unsigned)blocks, kThreads, 0,
                                 (cudaStream_t)stream>>>(
      (const T*)vals, (const int32_t*)perm, (const int32_t*)slot, (T*)out, L,
      nzmax);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_sum2(const void* va, const void* vb, const void* sa,
                const void* sb, const void* slot, void* out, long long L,
                long long nzmax, void* stream) {
  const long long blocks = (L + kThreads - 1) / kThreads;
  gather2_segment_sum_kernel<T><<<(unsigned)blocks, kThreads, 0,
                                  (cudaStream_t)stream>>>(
      (const T*)va, (const T*)vb, (const int32_t*)sa, (const int32_t*)sb,
      (const int32_t*)slot, (T*)out, L, nzmax);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_minmax(const void* vals, const void* perm, const void* slot,
                  void* out, long long L, long long nzmax, int is_max,
                  void* stream) {
  const long long blocks = (L + kThreads - 1) / kThreads;
  if (is_max)
    gather_segment_minmax_kernel<T, true><<<(unsigned)blocks, kThreads, 0,
                                            (cudaStream_t)stream>>>(
        (const T*)vals, (const int32_t*)perm, (const int32_t*)slot, (T*)out,
        L, nzmax);
  else
    gather_segment_minmax_kernel<T, false><<<(unsigned)blocks, kThreads, 0,
                                             (cudaStream_t)stream>>>(
        (const T*)vals, (const int32_t*)perm, (const int32_t*)slot, (T*)out,
        L, nzmax);
  return (int)cudaGetLastError();
}

// scratch: 1 + 2 ntiles (float32) or 1 + 4 ntiles (float64) zeroed
// 64-bit words: the tile ticket, then the descriptors
template <typename T>
int launch_cumsum(const void* x, void* out, void* scratch, long long L,
                  void* stream) {
  using S = ScanShape<T>;
  const long long ntiles = (L + S::kTile - 1) / S::kTile;
  unsigned long long* w = (unsigned long long*)scratch;
  const int vec = (((uintptr_t)x | (uintptr_t)out) & 15) == 0;
  cudaStream_t s = (cudaStream_t)stream;
  if constexpr (sizeof(T) == 4) {
    scan_lookback_kernel<T><<<(unsigned)ntiles, kThreads, 0, s>>>(
        (const T*)x, (T*)out, L, (int*)w, DescF32{w + 1, w + 1 + ntiles},
        vec);
  } else {
    scan_lookback_kernel<T><<<(unsigned)ntiles, kThreads, 0, s>>>(
        (const T*)x, (T*)out, L, (int*)w,
        DescF64{(int*)(w + 1), (double*)(w + 1 + ntiles),
                (double*)(w + 1 + 2 * ntiles), (double*)(w + 1 + 3 * ntiles)},
        vec);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int gather_segment_sum_f32_launch(const void* vals,
                                             const void* perm,
                                             const void* slot, void* out,
                                             long long L, long long nzmax,
                                             void* stream) {
  return launch_sum<float>(vals, perm, slot, out, L, nzmax, stream);
}

extern "C" int gather_segment_sum_f64_launch(const void* vals,
                                             const void* perm,
                                             const void* slot, void* out,
                                             long long L, long long nzmax,
                                             void* stream) {
  return launch_sum<double>(vals, perm, slot, out, L, nzmax, stream);
}

extern "C" int gather2_segment_sum_f32_launch(
    const void* va, const void* vb, const void* sa, const void* sb,
    const void* slot, void* out, long long L, long long nzmax, void* stream) {
  return launch_sum2<float>(va, vb, sa, sb, slot, out, L, nzmax, stream);
}

extern "C" int gather2_segment_sum_f64_launch(
    const void* va, const void* vb, const void* sa, const void* sb,
    const void* slot, void* out, long long L, long long nzmax, void* stream) {
  return launch_sum2<double>(va, vb, sa, sb, slot, out, L, nzmax, stream);
}

extern "C" int gather_segment_minmax_f32_launch(const void* vals,
                                                const void* perm,
                                                const void* slot, void* out,
                                                long long L, long long nzmax,
                                                int is_max, void* stream) {
  return launch_minmax<float>(vals, perm, slot, out, L, nzmax, is_max,
                              stream);
}

extern "C" int gather_segment_minmax_f64_launch(const void* vals,
                                                const void* perm,
                                                const void* slot, void* out,
                                                long long L, long long nzmax,
                                                int is_max, void* stream) {
  return launch_minmax<double>(vals, perm, slot, out, L, nzmax, is_max,
                               stream);
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
