// B8: the padded-ELL SpMV.
//
// Replaces repro/kernels/spmv/spmv.py:spmv_ell (_spmv_ell_kernel):
// y[r] = sum_k vals[r, k] * x[cols[r, k]] over the K slots of row r, where
// col == N marks padding and reads 0.  The TPU kernel pads x with a
// trailing zero (x[N] = 0) kept resident in VMEM and gathers a [Br, K]
// tile per grid step; here there is no padded copy of x, so the padding is
// a branch and x[N] is never read.
//
// What bounds it on the H100: bytes.  It reads cols and vals once (8MK B
// in f32), gathers x (4N B at least, from L2 for a vector of a few MB)
// and writes y (4M B); one multiply and one add per slot.
//
// What the simple design does about it: one thread per row walks its K
// slots in order.  Neighbouring threads read neighbouring rows, so a warp
// reads 32K consecutive values of cols and vals (every fetched sector is
// used, through L1) and writes 32 consecutive outputs.  Each product is
// rounded before the add (no FMA contraction), as the plain version
// rounds it; the sum runs in slot order.
#include <cstdint>
#include <cuda_runtime.h>
#include "resources.cuh"

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float mul_rn(float a, float b) {
  return __fmul_rn(a, b);
}
__device__ __forceinline__ double mul_rn(double a, double b) {
  return __dmul_rn(a, b);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
spmv_ell_kernel(const int32_t* __restrict__ cols, const T* __restrict__ vals,
                const T* __restrict__ x, T* __restrict__ y, long long M,
                int K, long long N) {
  const long long r = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (r >= M) return;
  const int32_t* c = cols + r * K;
  const T* v = vals + r * K;
  T acc = T(0);
  for (int k = 0; k < K; ++k) {
    const int col = __ldg(c + k);
    if (col >= 0 && col < N)  // col == N is padding: never read x[N]
      acc += mul_rn(__ldg(v + k), __ldg(x + col));
  }
  y[r] = acc;
}

template <typename T>
int launch(const void* cols, const void* vals, const void* x, void* y,
           long long M, int K, long long N, void* stream) {
  const long long blocks = (M + kThreads - 1) / kThreads;
  spmv_ell_kernel<T><<<(unsigned)blocks, kThreads, 0,
                       (cudaStream_t)stream>>>(
      (const int32_t*)cols, (const T*)vals, (const T*)x, (T*)y, M, K, N);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int spmv_ell_f32_launch(const void* cols, const void* vals,
                                   const void* x, void* y, long long M, int K,
                                   long long N, void* stream) {
  return launch<float>(cols, vals, x, y, M, K, N, stream);
}

extern "C" int spmv_ell_f64_launch(const void* cols, const void* vals,
                                   const void* x, void* y, long long M, int K,
                                   long long N, void* stream) {
  return launch<double>(cols, vals, x, y, M, K, N, stream);
}

// rows (threads) a block: the spmv tuning spec's build-time block_r
extern "C" int spmv_block_rows(void) { return kThreads; }

namespace {
const KernelResource kResources[] = {
    {"spmv_ell_f32", (const void*)spmv_ell_kernel<float>, kThreads, 0},
    {"spmv_ell_f64", (const void*)spmv_ell_kernel<double>, kThreads, 0},
};
}  // namespace
REPRO_RESOURCE_TABLE(kResources)
