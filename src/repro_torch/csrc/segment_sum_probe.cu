// Timing probes of B3', B4 and B6 (csrc/segment_sum.cu), for comparison
// only: nothing in the port calls them.  kernel_times.py and
// chip_smoke.py time them beside the kernels.
//
//  - The gather floor: B3''s loads with the reduction removed,
//    y[j] = vals[perm[j]] where slot[j] is kept (else 0), with the same
//    striped 16 B index loads, cache hints and K gathers in flight a
//    thread, stored coalesced.  No design that gathers vals[perm] beats
//    it on the same streams.  The two-gather floor is B6's: its three
//    index streams, 2K gathers in flight and rounded products,
//    y[j] = va[sa[j]] * vb[sb[j]], stored the same way.
//  - B3' at other tile depths K (4, 12, 16), with more resident blocks,
//    and with the index streams read through the read-only cache (__ldg)
//    instead of streaming (__ldcs).
//  - B6 at other tile depths K (4, 8, 12) and register bounds, and with
//    the index streams read through __ldg.
//  - The design B3', B4 and B6 replaced: one thread a sorted position;
//    the thread at a kept run's start walks the run and writes its total
//    (a long run serialises on that thread).
#include "segment_sum.cu"

namespace {

template <typename T, int K, typename Ld, typename Src>
__global__ void __launch_bounds__(kThreads)
gather_floor_kernel(Src src, const int32_t* __restrict__ slot,
                    T* __restrict__ y, long long L, long long nzmax,
                    int vec) {
  constexpr int kTile = kThreads * K;
  __shared__ int32_t ss[kTile + kTile / 32];
  __shared__ T vv[kTile + kTile / (128 / sizeof(T))];
  const long long t0 = (long long)blockIdx.x * kTile;
  if (vec && t0 + kTile <= L)
    seg_load<T, SumOp<T>, K, Ld, true>(src, slot, t0, L, nzmax, ss, vv);
  else
    seg_load<T, SumOp<T>, K, Ld, false>(src, slot, t0, L, nzmax, ss, vv);
  __syncthreads();
#pragma unroll
  for (int q = 0; q < K; ++q) {
    const int j = q * kThreads + threadIdx.x;
    if (t0 + j < L) __stcs(y + t0 + j, vv[pad<T>(j)]);
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
legacy_sum_kernel(const T* __restrict__ vals, const int32_t* __restrict__ perm,
                  const int32_t* __restrict__ slot, T* __restrict__ out,
                  long long L, long long nzmax) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= L) return;
  const int s = __ldg(slot + i);
  if (s < 0 || s >= nzmax) return;
  if (i > 0 && __ldg(slot + i - 1) == s) return;
  T acc = T(0);
  for (long long j = i; j < L && __ldg(slot + j) == s; ++j)
    acc += __ldg(vals + __ldg(perm + j));
  out[s] = acc;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
legacy_sum2_kernel(const T* __restrict__ va, const T* __restrict__ vb,
                   const int32_t* __restrict__ sa,
                   const int32_t* __restrict__ sb,
                   const int32_t* __restrict__ slot, T* __restrict__ out,
                   long long L, long long nzmax) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= L) return;
  const int s = __ldg(slot + i);
  if (s < 0 || s >= nzmax) return;
  if (i > 0 && __ldg(slot + i - 1) == s) return;
  T acc = T(0);
  for (long long j = i; j < L && __ldg(slot + j) == s; ++j)
    acc += mul_rn(__ldg(va + __ldg(sa + j)), __ldg(vb + __ldg(sb + j)));
  out[s] = acc;
}

template <typename T, int K, typename Src>
int launch_floor(const Src& src, const void* slot, void* y, long long L,
                 long long nzmax, void* stream) {
  constexpr int kTile = kThreads * K;
  const int vec = ((src.bits() | (uintptr_t)slot) & 15) == 0;
  gather_floor_kernel<T, K, LdStream>
      <<<(unsigned)((L + kTile - 1) / kTile), kThreads, 0,
         (cudaStream_t)stream>>>(src, (const int32_t*)slot, (T*)y, L, nzmax,
                                 vec);
  return (int)cudaGetLastError();
}

template <typename T, bool kMax>
__global__ void __launch_bounds__(kThreads)
legacy_minmax_kernel(const T* __restrict__ vals,
                     const int32_t* __restrict__ perm,
                     const int32_t* __restrict__ slot, T* __restrict__ out,
                     long long L, long long nzmax) {
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

}  // namespace

// The probes' variants: 0 the replaced design; 1 K = 4; 2 as shipped
// (K = kSegPer, kSegMinBlocks); 3 K = 16; 4 as shipped with the index
// streams read through __ldg; 5 K = kSegPer with at least 6 blocks an SM
// (40 registers); 6 K = 16 with at least 4; 7 K = 12; 8 K = kSegPer
// unbounded (56 registers); 9 K = 4 with at least 8 blocks; 10 K = 12
// with at least 5.  Without a bound ("unbounded", 1 block) the compiler
// takes as many registers as it likes.  scratch: zeroed words for the
// smallest tile (K = 4).
extern "C" int probe_segment_sum_f32_launch(int variant, const void* vals,
                                            const void* perm,
                                            const void* slot, void* out,
                                            void* scratch, long long L,
                                            long long nzmax, void* stream) {
  using Op = SumOp<float>;
  using S = LdStream;
  switch (variant) {
    case 0:
      legacy_sum_kernel<float>
          <<<(unsigned)((L + kThreads - 1) / kThreads), kThreads, 0,
             (cudaStream_t)stream>>>((const float*)vals, (const int32_t*)perm,
                                     (const int32_t*)slot, (float*)out, L,
                                     nzmax);
      return (int)cudaGetLastError();
    case 1:
      return launch_segment<float, Op, 4, S, 1>(vals, perm, slot, out,
                                                scratch, L, nzmax, stream);
    case 2:
      return launch_segment<float, Op>(vals, perm, slot, out, scratch, L,
                                       nzmax, stream);
    case 3:
      return launch_segment<float, Op, 16, S, 1>(vals, perm, slot, out,
                                                 scratch, L, nzmax, stream);
    case 4:
      return launch_segment<float, Op, kSegPer, LdCached>(
          vals, perm, slot, out, scratch, L, nzmax, stream);
    case 5:
      return launch_segment<float, Op, kSegPer, S, 6>(
          vals, perm, slot, out, scratch, L, nzmax, stream);
    case 6:
      return launch_segment<float, Op, 16, S, 4>(vals, perm, slot, out,
                                                 scratch, L, nzmax, stream);
    case 7:
      return launch_segment<float, Op, 12, S, 1>(vals, perm, slot, out,
                                                 scratch, L, nzmax, stream);
    case 8:
      return launch_segment<float, Op, kSegPer, S, 1>(
          vals, perm, slot, out, scratch, L, nzmax, stream);
    case 9:
      return launch_segment<float, Op, 4, S, 8>(vals, perm, slot, out,
                                                scratch, L, nzmax, stream);
    case 10:
      return launch_segment<float, Op, 12, S, 5>(vals, perm, slot, out,
                                                 scratch, L, nzmax, stream);
  }
  return (int)cudaErrorInvalidValue;
}

// B4 (max): 0 the replaced design, 2 as shipped.
extern "C" int probe_segment_max_f32_launch(int variant, const void* vals,
                                            const void* perm,
                                            const void* slot, void* out,
                                            void* scratch, long long L,
                                            long long nzmax, void* stream) {
  if (variant == 0) {
    legacy_minmax_kernel<float, true>
        <<<(unsigned)((L + kThreads - 1) / kThreads), kThreads, 0,
           (cudaStream_t)stream>>>((const float*)vals, (const int32_t*)perm,
                                   (const int32_t*)slot, (float*)out, L,
                                   nzmax);
    return (int)cudaGetLastError();
  }
  if (variant == 2)
    return launch_segment<float, MinMaxOp<float, true>>(
        vals, perm, slot, out, scratch, L, nzmax, stream);
  return (int)cudaErrorInvalidValue;
}

// The gather floor at B3''s K and loads (variant 2) or at K = 16
// (variant 3); y holds L values.
extern "C" int probe_gather_floor_f32_launch(int variant, const void* vals,
                                             const void* perm,
                                             const void* slot, void* y,
                                             long long L, long long nzmax,
                                             void* stream) {
  const Gather<float> src{(const float*)vals, (const int32_t*)perm};
  if (variant == 2)
    return launch_floor<float, kSegPer>(src, slot, y, L, nzmax, stream);
  if (variant == 3)
    return launch_floor<float, 16>(src, slot, y, L, nzmax, stream);
  return (int)cudaErrorInvalidValue;
}

// B6 (float32): 0 the replaced design; 1 as shipped (kSum2Per,
// kSum2MinBlocks); 2 K = 4 unbounded; 3 K = 4 with at least 8 blocks an
// SM; 4 K = 8 unbounded; 5 K = 8 with at least 5; 6 K = 8 with at least
// 4; 7 K = 12 unbounded; 8 K = 12 with at least 4; 9 K = 12 with at
// least 3; 10 as shipped with the index streams read through __ldg; 11
// K = 8 with at least 6; 12 K = 12 with at least 5.
// scratch: zeroed words for the smallest tile (K = 4).
extern "C" int probe_product_sum_f32_launch(int variant, const void* va,
                                            const void* vb, const void* sa,
                                            const void* sb, const void* slot,
                                            void* out, void* scratch,
                                            long long L, long long nzmax,
                                            void* stream) {
  using S = LdStream;
  switch (variant) {
    case 0:
      legacy_sum2_kernel<float>
          <<<(unsigned)((L + kThreads - 1) / kThreads), kThreads, 0,
             (cudaStream_t)stream>>>(
              (const float*)va, (const float*)vb, (const int32_t*)sa,
              (const int32_t*)sb, (const int32_t*)slot, (float*)out, L,
              nzmax);
      return (int)cudaGetLastError();
    case 1:
      return launch_sum2<float>(va, vb, sa, sb, slot, out, scratch, L, nzmax,
                                stream);
    case 2:
      return launch_sum2<float, 4, S, 1>(va, vb, sa, sb, slot, out, scratch,
                                         L, nzmax, stream);
    case 3:
      return launch_sum2<float, 4, S, 8>(va, vb, sa, sb, slot, out, scratch,
                                         L, nzmax, stream);
    case 4:
      return launch_sum2<float, 8, S, 1>(va, vb, sa, sb, slot, out, scratch,
                                         L, nzmax, stream);
    case 5:
      return launch_sum2<float, 8, S, 5>(va, vb, sa, sb, slot, out, scratch,
                                         L, nzmax, stream);
    case 6:
      return launch_sum2<float, 8, S, 4>(va, vb, sa, sb, slot, out, scratch,
                                         L, nzmax, stream);
    case 7:
      return launch_sum2<float, 12, S, 1>(va, vb, sa, sb, slot, out, scratch,
                                          L, nzmax, stream);
    case 8:
      return launch_sum2<float, 12, S, 4>(va, vb, sa, sb, slot, out, scratch,
                                          L, nzmax, stream);
    case 9:
      return launch_sum2<float, 12, S, 3>(va, vb, sa, sb, slot, out, scratch,
                                          L, nzmax, stream);
    case 10:
      return launch_sum2<float, kSum2Per, LdCached,
                         kSum2MinBlocks<float>>(va, vb, sa, sb, slot, out,
                                                scratch, L, nzmax, stream);
    case 11:
      return launch_sum2<float, 8, S, 6>(va, vb, sa, sb, slot, out, scratch,
                                         L, nzmax, stream);
    case 12:
      return launch_sum2<float, 12, S, 5>(va, vb, sa, sb, slot, out, scratch,
                                          L, nzmax, stream);
  }
  return (int)cudaErrorInvalidValue;
}

// The two-gather floor at B6's K and loads (variant 1), at K = 4 (2) or
// K = 12 (3); y holds L values.
extern "C" int probe_gather2_floor_f32_launch(int variant, const void* va,
                                              const void* vb, const void* sa,
                                              const void* sb,
                                              const void* slot, void* y,
                                              long long L, long long nzmax,
                                              void* stream) {
  const Gather2<float> src{(const float*)va, (const float*)vb,
                           (const int32_t*)sa, (const int32_t*)sb};
  if (variant == 1)
    return launch_floor<float, kSum2Per>(src, slot, y, L, nzmax, stream);
  if (variant == 2)
    return launch_floor<float, 4>(src, slot, y, L, nzmax, stream);
  if (variant == 3)
    return launch_floor<float, 12>(src, slot, y, L, nzmax, stream);
  return (int)cudaErrorInvalidValue;
}
