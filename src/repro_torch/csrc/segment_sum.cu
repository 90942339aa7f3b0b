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
// the card run in no order, so this is reduce-then-scan in three
// launches over tiles of kScanTile values: (1) each tile's sum, (2) one
// block scans the tile sums into each tile's exclusive offset, (3) each
// tile's scan plus its offset.  Bound: bytes, one read and one write of
// x (8L B in f32) plus a second read in (3); a few adds per element.
// The sums are taken in another order than a sequential cumsum: on
// integer-valued data below 2^24 the result is exact, otherwise each
// output is within (depth of its addition tree, under 64) * eps of the
// running sum of |x|.
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
constexpr int kScanPerThread = 16;
constexpr int kScanTile = kThreads * kScanPerThread;  // values per tile
constexpr int kOffsetThreads = 1024;                  // the tile-sum scan

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

// Inclusive scan of one value per thread across a block of kN threads;
// `warps` is kN / 32 values of shared scratch.  Ends synchronised.
template <typename T, int kN>
__device__ __forceinline__ T block_inclusive_scan(T x, T* warps) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  x = warp_inclusive_scan(x);
  if (lane == 31) warps[warp] = x;
  __syncthreads();
  if (warp == 0) {
    T w = lane < kN / 32 ? warps[lane] : T(0);
    w = warp_inclusive_scan(w);
    if (lane < kN / 32) warps[lane] = w;
  }
  __syncthreads();
  if (warp > 0) x += warps[warp - 1];
  __syncthreads();
  return x;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
scan_tile_sums_kernel(const T* __restrict__ x, T* __restrict__ sums,
                      long long L) {
  __shared__ T warps[kThreads / 32];
  const long long t0 = (long long)blockIdx.x * kScanTile;
  T acc = T(0);
#pragma unroll
  for (int k = 0; k < kScanPerThread; ++k) {
    const long long g = t0 + k * kThreads + threadIdx.x;
    if (g < L) acc += __ldg(x + g);
  }
  acc = block_inclusive_scan<T, kThreads>(acc, warps);
  if (threadIdx.x == kThreads - 1) sums[blockIdx.x] = acc;
}

template <typename T>
__global__ void __launch_bounds__(kOffsetThreads)
scan_tile_offsets_kernel(const T* __restrict__ sums, T* __restrict__ offs,
                         long long ntiles) {
  __shared__ T warps[kOffsetThreads / 32];
  __shared__ T inc[kOffsetThreads];
  T carry = T(0);
  for (long long base = 0; base < ntiles; base += kOffsetThreads) {
    const long long i = base + threadIdx.x;
    const T v = i < ntiles ? sums[i] : T(0);
    inc[threadIdx.x] = block_inclusive_scan<T, kOffsetThreads>(v, warps);
    __syncthreads();
    if (i < ntiles)
      offs[i] = carry + (threadIdx.x ? inc[threadIdx.x - 1] : T(0));
    carry += inc[kOffsetThreads - 1];
    __syncthreads();
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
scan_tile_apply_kernel(const T* __restrict__ x, const T* __restrict__ offs,
                       T* __restrict__ out, long long L) {
  __shared__ T tile[kScanTile];
  __shared__ T warps[kThreads / 32];
  __shared__ T totals[kThreads];
  const long long t0 = (long long)blockIdx.x * kScanTile;
#pragma unroll
  for (int k = 0; k < kScanPerThread; ++k) {
    const int idx = k * kThreads + threadIdx.x;
    const long long g = t0 + idx;
    tile[idx] = g < L ? __ldg(x + g) : T(0);
  }
  __syncthreads();
  // each thread scans its own kScanPerThread consecutive values
  T* mine = tile + threadIdx.x * kScanPerThread;
  T run = T(0);
#pragma unroll
  for (int k = 0; k < kScanPerThread; ++k) {
    run += mine[k];
    mine[k] = run;
  }
  totals[threadIdx.x] = block_inclusive_scan<T, kThreads>(run, warps);
  __syncthreads();
  const T base =
      offs[blockIdx.x] + (threadIdx.x ? totals[threadIdx.x - 1] : T(0));
#pragma unroll
  for (int k = 0; k < kScanPerThread; ++k) mine[k] = base + mine[k];
  __syncthreads();
#pragma unroll
  for (int k = 0; k < kScanPerThread; ++k) {
    const int idx = k * kThreads + threadIdx.x;
    const long long g = t0 + idx;
    if (g < L) out[g] = tile[idx];
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

template <typename T>
int launch_cumsum(const void* x, void* sums, void* offs, void* out,
                  long long L, void* stream) {
  const long long ntiles = (L + kScanTile - 1) / kScanTile;
  cudaStream_t s = (cudaStream_t)stream;
  scan_tile_sums_kernel<T><<<(unsigned)ntiles, kThreads, 0, s>>>(
      (const T*)x, (T*)sums, L);
  int rc = (int)cudaGetLastError();
  if (rc) return rc;
  scan_tile_offsets_kernel<T><<<1, kOffsetThreads, 0, s>>>(
      (const T*)sums, (T*)offs, ntiles);
  rc = (int)cudaGetLastError();
  if (rc) return rc;
  scan_tile_apply_kernel<T><<<(unsigned)ntiles, kThreads, 0, s>>>(
      (const T*)x, (const T*)offs, (T*)out, L);
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

extern "C" int blocked_cumsum_f32_launch(const void* x, void* sums,
                                         void* offs, void* out, long long L,
                                         void* stream) {
  return launch_cumsum<float>(x, sums, offs, out, L, stream);
}

extern "C" int blocked_cumsum_f64_launch(const void* x, void* sums,
                                         void* offs, void* out, long long L,
                                         void* stream) {
  return launch_cumsum<double>(x, sums, offs, out, L, stream);
}

extern "C" int scan_tile(void) { return kScanTile; }
