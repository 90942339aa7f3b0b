// Timing probes of B7 (csrc/merge.cu), for comparison only: nothing in
// the port calls them.  chip_smoke.py and kernel_times.py time them beside
// the kernel, at both of its call sites.
//
//  - The design B7 replaced (the first port): one thread a query walks the
//    reference's whole bit_length(n) ladder, reading both target arrays
//    at every probe.
//  - B7's two kernels whatever Lq and n (the launcher's choice is timed
//    against them over a sweep of Lq and n).
//  - Shapes that lost (probe_merge_search_launch lists them), from one
//    kernel with the choices as template parameters: the block's
//    narrowing without splitters, splitters of all of [0, n), 1 or 2
//    queries a thread stepping together, the row read on ties only to
//    the end of the ladder.
#include "merge.cu"

namespace {

// The replaced design (the first port).
template <bool kInclusive>
__global__ void __launch_bounds__(kThreads)
replaced_search_kernel(const int32_t* __restrict__ qr,
                       const int32_t* __restrict__ qc,
                       const int32_t* __restrict__ tr,
                       const int32_t* __restrict__ tc,
                       int32_t* __restrict__ out, long long Lq, int n,
                       int steps) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= Lq) return;
  const int32_t r = __ldg(qr + i);
  const int32_t c = __ldg(qc + i);
  int lo = 0, hi = n;
  for (int s = 0; s < steps && lo < hi; ++s) {
    const int mid = lo + ((hi - lo) >> 1);
    if (below<kInclusive>(__ldg(tc + mid), __ldg(tr + mid), c, r)) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  out[i] = lo;
}

// kNarrow: the block's least and greatest key searched first (else every
// query starts from [0, n)); kSplit: splitters in shared memory (0: none);
// kQ: queries a thread, whose ladders step together; kSpec: the targets
// left below which a probe reads both arrays.
template <bool kInclusive, bool kNarrow, int kSplit, int kQ, int kSpec>
__global__ void __launch_bounds__(kThreads)
variant_search_kernel(const int32_t* __restrict__ qr,
                      const int32_t* __restrict__ qc,
                      const int32_t* __restrict__ tr,
                      const int32_t* __restrict__ tc,
                      int32_t* __restrict__ out, long long Lq, int n) {
  __shared__ long long red[2][kWarps];
  __shared__ long long split[kSplit > 1 ? kSplit - 1 : 1];
  __shared__ int range_s[2];
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const long long base = (long long)blockIdx.x * kThreads * kQ + t;
  int32_t r[kQ], c[kQ];
  long long mn = LLONG_MAX, mx = LLONG_MIN;
#pragma unroll
  for (int q = 0; q < kQ; ++q) {
    const long long i = base + q * kThreads;
    r[q] = i < Lq ? __ldcs(qr + i) : 0;
    c[q] = i < Lq ? __ldcs(qc + i) : 0;
    if (i < Lq) {
      const long long k = pack(c[q], r[q]);
      mn = min(mn, k);
      mx = max(mx, k);
    }
  }
  int lo0 = 0, hi0 = n;
  if (kNarrow) {
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
    if (warp < 2) {
      long long key = red[warp][0];
#pragma unroll
      for (int w = 1; w < kWarps; ++w)
        key = warp == 0 ? min(key, red[0][w]) : max(key, red[1][w]);
      const int a = warp_search<kInclusive>(tr, tc, key, 0, n);
      if (lane == 0) range_s[warp] = a;
    }
    __syncthreads();
    lo0 = range_s[0];
    hi0 = range_s[1];
  }
  int lo[kQ], hi[kQ];
#pragma unroll
  for (int q = 0; q < kQ; ++q) {
    lo[q] = lo0;
    hi[q] = hi0;
  }
  if (kSplit > 1 && hi0 - lo0 > kSplit) {
    const long long R = hi0 - lo0;
    for (int s = t; s < kSplit - 1; s += kThreads) {
      const int p = lo0 + (int)((R * (s + 1)) / kSplit);
      split[s] = pack(__ldg(tc + p), __ldg(tr + p));
    }
    __syncthreads();
#pragma unroll
    for (int q = 0; q < kQ; ++q) {
      const long long k = pack(c[q], r[q]);
      int a = 0, b = kSplit - 1;
      while (a < b) {
        const int m = (a + b) >> 1;
        if (below<kInclusive>(split[m], k)) {
          a = m + 1;
        } else {
          b = m;
        }
      }
      if (a > 0) lo[q] = lo0 + (int)((R * a) / kSplit) + 1;
      if (a < kSplit - 1) hi[q] = lo0 + (int)((R * (a + 1)) / kSplit);
    }
  }
  while (true) {
    bool more = false;
#pragma unroll
    for (int q = 0; q < kQ; ++q) {
      if (lo[q] < hi[q]) {
        more = true;
        ladder_step<kInclusive, kSpec>(tr, tc, c[q], r[q], lo[q], hi[q]);
      }
    }
    if (!more) break;
  }
#pragma unroll
  for (int q = 0; q < kQ; ++q) {
    const long long i = base + q * kThreads;
    if (i < Lq) out[i] = lo[q];
  }
}

template <bool kInclusive>
int launch_variant(int variant, const int32_t* qr, const int32_t* qc,
                   const int32_t* tr, const int32_t* tc, int32_t* out,
                   long long Lq, int n, cudaStream_t s) {
  const unsigned blocks1 = (unsigned)((Lq + kThreads - 1) / kThreads);
  const unsigned blocks2 =
      (unsigned)((Lq + 2 * kThreads - 1) / (2 * kThreads));
  const unsigned blocks4 =
      (unsigned)((Lq + kThreads * kQueries - 1) / (kThreads * kQueries));
  switch (variant) {
    case 0: {
      int steps = 1;
      while ((1LL << steps) <= n) ++steps;  // bit_length(n), at least 1
      replaced_search_kernel<kInclusive><<<blocks1, kThreads, 0, s>>>(
          qr, qc, tr, tc, out, Lq, n, steps);
      break;
    }
    case 1:
      launch<kInclusive>(qr, qc, tr, tc, out, Lq, n, s);
      break;
    case 2:  // the ladder reading rows on ties
      ladder_search_kernel<kInclusive, true><<<blocks1, kThreads, 0, s>>>(
          qr, qc, tr, tc, out, Lq, n);
      break;
    case 3:
      dense_search_kernel<kInclusive><<<blocks4, kThreads, 0, s>>>(
          qr, qc, tr, tc, out, Lq, n);
      break;
    case 4:  // rows on ties to the end of the ladder
      variant_search_kernel<kInclusive, false, 0, 1, 0>
          <<<blocks1, kThreads, 0, s>>>(qr, qc, tr, tc, out, Lq, n);
      break;
    case 5:  // splitters of all of [0, n)
      variant_search_kernel<kInclusive, false, kSplitters, 1, 0>
          <<<blocks1, kThreads, 0, s>>>(qr, qc, tr, tc, out, Lq, n);
      break;
    case 6:  // the narrowing alone, both arrays at every probe
      variant_search_kernel<kInclusive, true, 0, 1, INT_MAX>
          <<<blocks1, kThreads, 0, s>>>(qr, qc, tr, tc, out, Lq, n);
      break;
    case 7:  // the dense kernel, rows on ties to the end
      variant_search_kernel<kInclusive, true, kSplitters, kQueries, 0>
          <<<blocks4, kThreads, 0, s>>>(qr, qc, tr, tc, out, Lq, n);
      break;
    case 8:  // rows on ties, 2 queries a thread
      variant_search_kernel<kInclusive, false, 0, 2, kSpecSparse>
          <<<blocks2, kThreads, 0, s>>>(qr, qc, tr, tc, out, Lq, n);
      break;
    case 9:  // the ladder, both arrays at every probe
      ladder_search_kernel<kInclusive, false><<<blocks1, kThreads, 0, s>>>(
          qr, qc, tr, tc, out, Lq, n);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // namespace

// variant: 0 the replaced design, 1 as shipped (the launcher's choice),
// then whatever Lq and n: 2 the ladder reading rows on ties above 16
// targets, 3 the dense kernel, 4 the ladder reading rows on ties to its
// end, 5 splitters of all of [0, n), 6 the narrowing alone, 7 the dense
// kernel reading rows on ties to the end, 8 the ladder reading rows on
// ties with 2 queries a thread, 9 the ladder reading both arrays.
extern "C" int probe_merge_search_launch(int variant, const void* qr,
                                         const void* qc, const void* tr,
                                         const void* tc, void* out,
                                         long long Lq, int n, int side,
                                         void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  return side ? launch_variant<true>(variant, (const int32_t*)qr,
                                     (const int32_t*)qc, (const int32_t*)tr,
                                     (const int32_t*)tc, (int32_t*)out, Lq,
                                     n, s)
              : launch_variant<false>(variant, (const int32_t*)qr,
                                      (const int32_t*)qc, (const int32_t*)tr,
                                      (const int32_t*)tc, (int32_t*)out, Lq,
                                      n, s);
}
