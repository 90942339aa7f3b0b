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
// Here there is no residency: the targets are read from device memory
// through the read-only path, so every n is served.
//
// What bounds it on the H100: bytes in the ideal, 12 Lq B (two query
// words in, one offset out) and 8 n B (each target read once); in fact
// the latency of the ladder's dependent loads, bit_length(n) of them per
// query, each a 4 B read of a 32 B sector.  The top levels of the ladder
// are the same few keys for every query and stay in L1/L2.
//
// What the simple design does about it: one thread per query walks the
// ladder of the reference (mid = lo + (hi - lo) / 2, which equals its
// (lo + hi) // 2 for non-negative bounds and cannot overflow near
// n = 2^30; the reference's clamp of mid to n - 1 is never needed while
// lo < hi).  In SparsePattern.update the queries are the sorted delta,
// so neighbouring threads walk nearly the same path; in
// pattern_symmetric they are the transposed structure and less coherent.
// The result is bit-identical to merge_search_ref.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

template <bool kInclusive>
__global__ void __launch_bounds__(kThreads)
merge_search_kernel(const int32_t* __restrict__ qr,
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
    const int32_t tcm = __ldg(tc + mid);
    const int32_t trm = __ldg(tr + mid);
    const bool below =
        tcm < c || (tcm == c && (kInclusive ? trm <= r : trm < r));
    if (below) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  out[i] = lo;
}

}  // namespace

// side: 0 = "left" (targets strictly below), 1 = "right" (at or below).
extern "C" int merge_search_launch(const void* qr, const void* qc,
                                   const void* tr, const void* tc, void* out,
                                   long long Lq, int n, int steps, int side,
                                   void* stream) {
  const long long blocks = (Lq + kThreads - 1) / kThreads;
  const cudaStream_t s = (cudaStream_t)stream;
  if (side) {
    merge_search_kernel<true><<<(unsigned)blocks, kThreads, 0, s>>>(
        (const int32_t*)qr, (const int32_t*)qc, (const int32_t*)tr,
        (const int32_t*)tc, (int32_t*)out, Lq, n, steps);
  } else {
    merge_search_kernel<false><<<(unsigned)blocks, kThreads, 0, s>>>(
        (const int32_t*)qr, (const int32_t*)qc, (const int32_t*)tr,
        (const int32_t*)tc, (int32_t*)out, Lq, n, steps);
  }
  return (int)cudaGetLastError();
}
