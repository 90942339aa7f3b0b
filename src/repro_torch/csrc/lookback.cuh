// The decoupled look-back shared by B3', B4, B5 (csrc/segment_sum.cu) and
// B9 (csrc/spmv_sym.cu): Merrill and Garland's single-pass carry across
// tiles that take their ids from an atomic ticket, the descriptors a tile
// publishes, the carried precision of the chain (Chain), the sum (SumOp)
// and a segmented warp scan.  A kernel that includes it defines the
// reductions it carries (an Op: identity, op, of, combine, value).
#pragma once
#include <cstdint>
#include <cuda_runtime.h>

namespace {

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
// eps P.  lead() is the leading part, exact for a value made by of().
template <typename T>
struct Chain;

template <>
struct Chain<float> {
  using Acc = double;
  static __device__ Acc of(float a) { return a; }
  static __device__ Acc add(Acc p, Acc a) { return p + a; }
  static __device__ float value(Acc p) { return (float)p; }
  static __device__ float lead(Acc p) { return (float)p; }
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
  static __device__ double lead(Acc p) { return p.hi; }
};

// The reductions the look-back kernels run: op() in the data's type
// (earlier operand first), combine() on the carried type.
template <typename T>
struct SumOp {
  using C = Chain<T>;
  using Acc = typename C::Acc;
  static __device__ T identity() { return T(0); }
  static __device__ T op(T a, T b) { return a + b; }
  static __device__ Acc of(T a) { return C::of(a); }
  static __device__ Acc combine(Acc a, Acc b) { return C::add(a, b); }
  static __device__ T value(Acc a) { return C::value(a); }
};

// float32: an aggregate word and a prefix word a tile, each one atomic
// 64-bit load or store of the double value XOR kEmpty, so that the
// zeroed word reads as not yet: no value carried here has kEmpty's bits
// (a signalling NaN whose low bits no float32 value converted to double
// has; NaNs computed on the card are quiet).
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

// The descriptors in the wrapper's zeroed scratch, after the ticket
// word: 2 words a tile (float32) or 4 (float64).
template <typename T>
struct DescOf;

template <>
struct DescOf<float> {
  static DescF32 at(unsigned long long* w, long long ntiles) {
    return {w + 1, w + 1 + ntiles};
  }
};

template <>
struct DescOf<double> {
  static DescF64 at(unsigned long long* w, long long ntiles) {
    return {(int*)(w + 1), (double*)(w + 1 + ntiles),
            (double*)(w + 1 + 2 * ntiles), (double*)(w + 1 + 3 * ntiles)};
  }
};

// Warp 0 of tile id > 0: the exclusive prefix of the tiles before it,
// written to `excl` by lane 0.  It reads 32 descriptors a window, one a
// lane, nearest first, keeping the values in `look`, until a window
// holds a prefix; past kLookWindows windows it reads the last one again
// until one appears.  Then lane 0 folds left to right from the nearest
// prefix P(s) through the aggregates a(s+1) .. a(id-1).  Every P(t) is
// thus P(t-1) + a(t), whichever prefix the look-back met: the result
// does not depend on timing.  Tiles take their ids from an atomic
// ticket, so every tile waited on has started: no deadlock.
template <typename Op, typename Desc>
__device__ __forceinline__ void look_back(const Desc& desc, int id,
                                          typename Op::Acc (*look)[32],
                                          typename Op::Acc& excl) {
  using Acc = typename Op::Acc;
  const int lane = threadIdx.x & 31;
  int w = 0, stop = 0;
  while (true) {
    const int pred = id - 1 - w * 32 - lane;  // this lane's descriptor
    Acc val = Op::of(Op::identity());
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
    // only the aggregates after the prefix: each combine waits on the last
    Acc e = look[w][stop];
    for (int q = stop - 1; q >= 0; --q) e = Op::combine(e, look[w][q]);
    for (int u = w - 1; u >= 0; --u)
      for (int q = 31; q >= 0; --q) e = Op::combine(e, look[u][q]);
    excl = e;
  }
}

// Segmented inclusive scan of (flag, value) across a warp.
template <typename Op, typename T>
__device__ __forceinline__ void warp_segscan(int& f, T& v) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int fu = __shfl_up_sync(0xffffffffu, f, d);
    const T vu = __shfl_up_sync(0xffffffffu, v, d);
    if (lane >= d) {
      if (!f) v = Op::op(vu, v);
      f |= fu;
    }
  }
}

}  // namespace
