// B7: the merge positioning search.
//
// Replaces repro/kernels/merge/merge.py:merge_search_pallas
// (_merge_search_kernel): for every query key (qc[i], qr[i]) the number
// of targets of a (col, row)-lexicographically sorted stream (tc, tr)
// that lie strictly below it (side "left") or at or below it (side
// "right").  The row == M padding sentinel takes part like any key.  The
// TPU kernel keeps both target vectors resident in VMEM (under an 8 MB
// budget, past which the reference falls back to its jnp version) and
// runs the ceil(log2 n) ladder over a block of queries per grid step.
// Here there is no residency: the targets are read from device memory,
// so every n is served.  The count is unique, so any search that finds it
// is bit-identical to merge_search_ref.
//
// What bounds it on the H100: bytes in the ideal, 12 Lq B (two query
// words in, one offset out) and 8 B for each target the search must
// read; in fact the 32 B sector each probe costs and the latency of
// dependent probes.  The design this one replaced (the first port; kept
// in merge_probe.cu) walks each query's whole bit_length(n) ladder on one
// thread, reading a sector of each of the two arrays at every probe: 26
// at the update of a 5e7 plan, 23 at the FEM symmetry probe.
//
// Two kernels, chosen by the launcher from Lq and n alone:
//  - dense queries (Lq * 4 >= n: the symmetry probe's Lq = n): a block
//    of 256 x 4 queries narrows its search together.  Warps 0 and 1 find
//    the counts of the block's least and greatest key by a 32-ary search
//    (31 lanes probe evenly spaced targets a round, a ballot picks the
//    32nd of the interval that holds the answer: ceil(log32 n) + 1 rounds
//    where the ladder needs bit_length(n)); every query's count lies
//    between them.  Past 256 targets the block loads 255 evenly spaced
//    splitters of that range into shared memory and each query
//    binary-searches them there; then each thread walks its 4 queries'
//    ladders a step together, reading the row only where the column ties
//    while more than 64 targets are left.  Neighbouring queries share
//    most of their ladders, so the block's shared steps replace most of
//    each query's;
//  - the others: one thread a query on the whole ladder.  Where few
//    queries go into targets past the L2 (Lq * 16 < n, n >= 2^23: the
//    update's 1% delta into a 5e7 plan) it reads the row only where the
//    column ties while more than 16 targets are left, so the upper levels
//    touch one array (fewer sectors from HBM, which bound this call), and
//    both arrays at once below that (the column mostly ties there, and a
//    dependent second load would add a round to a level).  Elsewhere (the
//    targets in the L2, or many queries: the 2.5e6 sets' updates, the 10%
//    delta at 5e7) it reads both arrays at every probe, as the replaced
//    design did, which measured fastest there.  The two are one kernel,
//    instanced twice.
// The thresholds, and the shapes that lost (merge_probe.cu), are timed in
// PERF.md by kernel_times.py.
#include <climits>
#include <cstdint>
#include <cuda_runtime.h>
#include "resources.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
// the dense kernel: queries a thread, splitters a block, and the targets
// left below which a probe reads both arrays
constexpr int kQueries = 4;
constexpr int kSplitters = 256;
constexpr int kSpecDense = 64;
// the ladder reading rows on ties: the targets left below which a probe
// reads both arrays
constexpr int kSpecSparse = 16;
// the choice (measured over n = 2^21 .. 2^25 and n / Lq = 1 .. 128 in
// PERF.md): dense when Lq * kDenseRatio >= n; rows on ties when Lq *
// kSparseRatio < n and n >= kSparseTargets (8n bytes of targets past the
// 50 MB L2)
constexpr int kDenseRatio = 4;
constexpr int kSparseRatio = 16;
constexpr int kSparseTargets = 1 << 23;

// The (col, row) key as one int64 ordered as the pair of signed int32s.
__device__ __forceinline__ long long pack(int32_t c, int32_t r) {
  return (long long)(((unsigned long long)(uint32_t)c << 32) |
                     (uint32_t)(r ^ INT_MIN));
}

template <bool kInclusive>
__device__ __forceinline__ bool below(long long target, long long query) {
  return kInclusive ? target <= query : target < query;
}

template <bool kInclusive>
__device__ __forceinline__ bool below(int32_t tc, int32_t tr, int32_t c,
                                      int32_t r) {
  return tc < c || (tc == c && (kInclusive ? tr <= r : tr < r));
}

// One step of the ladder over [lo, hi), lo < hi (mid = lo + (hi - lo) /
// 2, which equals the reference's (lo + hi) // 2 for non-negative bounds
// and cannot overflow near n = 2^30): the row is read only where the
// column ties while more than kSpec targets are left, else with it.
template <bool kInclusive, int kSpec>
__device__ __forceinline__ void ladder_step(const int32_t* __restrict__ tr,
                                            const int32_t* __restrict__ tc,
                                            int32_t c, int32_t r, int& lo,
                                            int& hi) {
  const int mid = lo + ((hi - lo) >> 1);
  const int32_t tcm = __ldg(tc + mid);
  bool b;
  if (hi - lo <= kSpec) {
    b = below<kInclusive>(tcm, __ldg(tr + mid), c, r);
  } else {
    b = tcm < c;
    if (tcm == c) {
      const int32_t trm = __ldg(tr + mid);
      b = kInclusive ? trm <= r : trm < r;
    }
  }
  if (b) {
    lo = mid + 1;
  } else {
    hi = mid;
  }
}

// A whole warp: the count of targets in [lo, hi) below `key` (all of
// [0, lo) being below and all of [hi, n) not), in rounds of 31 probes.
template <bool kInclusive>
__device__ int warp_search(const int32_t* __restrict__ tr,
                           const int32_t* __restrict__ tc, long long key,
                           int lo, int hi) {
  const int lane = threadIdx.x & 31;
  while (hi - lo > 32) {
    const long long span = hi - lo;
    int p = 0;
    bool b = false;
    if (lane < 31) {  // strictly increasing, as span > 32
      p = lo + (int)((span * (lane + 1)) >> 5);
      b = below<kInclusive>(pack(__ldg(tc + p), __ldg(tr + p)), key);
    }
    const int j = __popc(__ballot_sync(0xffffffffu, b));  // probes below
    const int pl = __shfl_sync(0xffffffffu, p, j > 0 ? j - 1 : 0);
    const int ph = __shfl_sync(0xffffffffu, p, j < 31 ? j : 30);
    if (j > 0) lo = pl + 1;
    if (j < 31) hi = ph;
  }
  bool b = false;
  if (lane < hi - lo)
    b = below<kInclusive>(pack(__ldg(tc + lo + lane), __ldg(tr + lo + lane)),
                          key);
  return lo + __popc(__ballot_sync(0xffffffffu, b));
}

// One thread a query on the whole ladder, the row read on ties while
// more than kSpecSparse targets are left (kTie) or at every probe.
template <bool kInclusive, bool kTie>
__global__ void __launch_bounds__(kThreads)
ladder_search_kernel(const int32_t* __restrict__ qr,
                     const int32_t* __restrict__ qc,
                     const int32_t* __restrict__ tr,
                     const int32_t* __restrict__ tc,
                     int32_t* __restrict__ out, long long Lq, int n) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= Lq) return;
  const int32_t r = __ldg(qr + i);
  const int32_t c = __ldg(qc + i);
  int lo = 0, hi = n;
  while (lo < hi)
    ladder_step<kInclusive, kTie ? kSpecSparse : INT_MAX>(tr, tc, c, r, lo,
                                                          hi);
  out[i] = lo;
}

// A block of kThreads x kQueries queries narrowed together (the head of
// this file).
template <bool kInclusive>
__global__ void __launch_bounds__(kThreads)
dense_search_kernel(const int32_t* __restrict__ qr,
                    const int32_t* __restrict__ qc,
                    const int32_t* __restrict__ tr,
                    const int32_t* __restrict__ tc,
                    int32_t* __restrict__ out, long long Lq, int n) {
  __shared__ long long red[2][kWarps];
  __shared__ long long split[kSplitters - 1];
  __shared__ int range_s[2];
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const long long base = (long long)blockIdx.x * kThreads * kQueries + t;

  // -- 1. the queries, and the block's least and greatest key -------------
  int32_t r[kQueries], c[kQueries];
  long long mn = LLONG_MAX, mx = LLONG_MIN;
#pragma unroll
  for (int q = 0; q < kQueries; ++q) {
    const long long i = base + q * kThreads;
    r[q] = i < Lq ? __ldcs(qr + i) : 0;
    c[q] = i < Lq ? __ldcs(qc + i) : 0;
    if (i < Lq) {
      const long long k = pack(c[q], r[q]);
      mn = min(mn, k);
      mx = max(mx, k);
    }
  }
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) {
    mn = min(mn, __shfl_xor_sync(0xffffffffu, mn, d));
    mx = max(mx, __shfl_xor_sync(0xffffffffu, mx, d));
  }
  if (lane == 0) {
    red[0][warp] = mn;
    red[1][warp] = mx;
  }
  __syncthreads();

  // -- 2. two warps, two 32-ary searches -----------------------------------
  if (warp < 2) {
    long long key = red[warp][0];
#pragma unroll
    for (int w = 1; w < kWarps; ++w)
      key = warp == 0 ? min(key, red[0][w]) : max(key, red[1][w]);
    const int a = warp_search<kInclusive>(tr, tc, key, 0, n);
    if (lane == 0) range_s[warp] = a;
  }
  __syncthreads();
  const int lo0 = range_s[0], hi0 = range_s[1];

  // -- 3. splitters of [lo0, hi0) in shared memory -------------------------
  int lo[kQueries], hi[kQueries];
#pragma unroll
  for (int q = 0; q < kQueries; ++q) {
    lo[q] = lo0;
    hi[q] = hi0;
  }
  if (hi0 - lo0 > kSplitters) {  // the same for the whole block
    const long long R = hi0 - lo0;
    // splitter s sits at b(s + 1), b(s) = lo0 + R s / kSplitters: strictly
    // increasing, as R > kSplitters, and below hi0
    for (int s = t; s < kSplitters - 1; s += kThreads) {
      const int p = lo0 + (int)((R * (s + 1)) / kSplitters);
      split[s] = pack(__ldg(tc + p), __ldg(tr + p));
    }
    __syncthreads();
#pragma unroll
    for (int q = 0; q < kQueries; ++q) {
      const long long k = pack(c[q], r[q]);
      int a = 0, b = kSplitters - 1;  // splitters below k: a prefix
      while (a < b) {
        const int m = (a + b) >> 1;
        if (below<kInclusive>(split[m], k)) {
          a = m + 1;
        } else {
          b = m;
        }
      }
      if (a > 0) lo[q] = lo0 + (int)((R * a) / kSplitters) + 1;
      if (a < kSplitters - 1)
        hi[q] = lo0 + (int)((R * (a + 1)) / kSplitters);
    }
  }

  // -- 4. the ladder in device memory, the queries a step together -------
  while (true) {
    bool more = false;
#pragma unroll
    for (int q = 0; q < kQueries; ++q) {
      if (lo[q] < hi[q]) {
        more = true;
        ladder_step<kInclusive, kSpecDense>(tr, tc, c[q], r[q], lo[q],
                                            hi[q]);
      }
    }
    if (!more) break;
  }
#pragma unroll
  for (int q = 0; q < kQueries; ++q) {
    const long long i = base + q * kThreads;
    if (i < Lq) out[i] = lo[q];
  }
}

// 2 the dense kernel, 1 the ladder reading rows on ties, 0 the ladder
// reading both arrays at every probe
int shape_of(long long Lq, int n) {
  if (Lq * kDenseRatio >= n) return 2;
  if (Lq * kSparseRatio < n && n >= kSparseTargets) return 1;
  return 0;
}

// shape < 0: the one shape_of gives (the priors'); else the caller's
template <bool kInclusive>
void launch(const int32_t* qr, const int32_t* qc, const int32_t* tr,
            const int32_t* tc, int32_t* out, long long Lq, int n,
            cudaStream_t s, int shape = -1) {
  const long long per = kThreads * kQueries;
  const unsigned blocks = (unsigned)((Lq + kThreads - 1) / kThreads);
  switch (shape < 0 ? shape_of(Lq, n) : shape) {
    case 2:
      dense_search_kernel<kInclusive>
          <<<(unsigned)((Lq + per - 1) / per), kThreads, 0, s>>>(
              qr, qc, tr, tc, out, Lq, n);
      break;
    case 1:
      ladder_search_kernel<kInclusive, true>
          <<<blocks, kThreads, 0, s>>>(qr, qc, tr, tc, out, Lq, n);
      break;
    default:
      ladder_search_kernel<kInclusive, false>
          <<<blocks, kThreads, 0, s>>>(qr, qc, tr, tc, out, Lq, n);
  }
}

}  // namespace

// side: 0 = "left" (targets strictly below), 1 = "right" (at or below).
// shape: as merge_shape() numbers them, chosen by the caller from its
// resolved thresholds (kernels/merge/ref.py merge_shape); -1 takes
// shape_of's.
extern "C" int merge_search_launch(const void* qr, const void* qc,
                                   const void* tr, const void* tc, void* out,
                                   long long Lq, int n, int side, int shape,
                                   void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  if (shape > 2) return (int)cudaErrorInvalidValue;
  if (side) {
    launch<true>((const int32_t*)qr, (const int32_t*)qc, (const int32_t*)tr,
                 (const int32_t*)tc, (int32_t*)out, Lq, n, s, shape);
  } else {
    launch<false>((const int32_t*)qr, (const int32_t*)qc, (const int32_t*)tr,
                  (const int32_t*)tc, (int32_t*)out, Lq, n, s, shape);
  }
  return (int)cudaGetLastError();
}

// the shape a call takes (0 the ladder, 1 the ladder reading rows on
// ties, 2 dense), the dense kernel's queries a block and its splitters:
// what ref.py's merge_shape and merge_search_narrowed_ref follow
extern "C" int merge_shape(long long Lq, int n) { return shape_of(Lq, n); }
extern "C" int merge_block_queries(void) { return kThreads * kQueries; }
extern "C" int merge_splitters(void) { return kSplitters; }

// the three shapes (side "left"; "right" is the same code)
namespace {
const KernelResource kResources[] = {
    {"merge_dense", (const void*)dense_search_kernel<false>, kThreads, 0},
    {"merge_sparse", (const void*)ladder_search_kernel<false, true>,
     kThreads, 0},
    {"merge_ladder", (const void*)ladder_search_kernel<false, false>,
     kThreads, 0},
};
}  // namespace
REPRO_RESOURCE_TABLE(kResources)
