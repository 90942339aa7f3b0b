// B3': the fused numeric fill -- gather + padding mask + segment sum.
//
// Replaces repro/kernels/segment_sum/segment_sum.py:gather_masked_cumsum
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
#include <cstdint>
#include <cuda_runtime.h>

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

template <typename T>
int launch(const void* vals, const void* perm, const void* slot, void* out,
           long long L, long long nzmax, void* stream) {
  const long long blocks = (L + kThreads - 1) / kThreads;
  gather_segment_sum_kernel<T><<<(unsigned)blocks, kThreads, 0,
                                 (cudaStream_t)stream>>>(
      (const T*)vals, (const int32_t*)perm, (const int32_t*)slot, (T*)out, L,
      nzmax);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int gather_segment_sum_f32_launch(const void* vals,
                                             const void* perm,
                                             const void* slot, void* out,
                                             long long L, long long nzmax,
                                             void* stream) {
  return launch<float>(vals, perm, slot, out, L, nzmax, stream);
}

extern "C" int gather_segment_sum_f64_launch(const void* vals,
                                             const void* perm,
                                             const void* slot, void* out,
                                             long long L, long long nzmax,
                                             void* stream) {
  return launch<double>(vals, perm, slot, out, L, nzmax, stream);
}
