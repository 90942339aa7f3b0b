// B9 (the symmetric SpMV's two streams) and B10 (the BSR tile products).
//
// B9 replaces repro/kernels/spmv_sym/spmv_sym.py:sym_streams
// (_sym_streams_kernel) together with the indptr-difference epilogue of
// repro/kernels/spmv_sym/ops.py:spmv_sym.  Over SymCSC's strict-upper
// stream (row r_s < col c_s, value a_s) it computes
//   up[s]  = a_s * x[c_s]                 (row direction; the caller
//                                          scatter-adds it by row)
//   ct[c]  = sum over column c of a_s * x[r_s]   (column direction)
// The TPU kernel emits a running sum of a_s * x[r_s] carried across
// in-order grid steps and the caller differences it at the indptr
// boundaries.  Blocks on the card run in no order, and a float32 running
// total past 2^24 drops low bits from every later column, so here each
// column's total is summed directly: one thread per column walks its slots
// indptr[c] .. indptr[c+1] in order, writes up[s] for each and ct[c] once.
// Slots whose row is the sentinel (r_s >= M) add nothing and get up = 0;
// the padded tail past indptr[M] is not visited (the caller zeroes up).
// Bound: bytes, rows and data read once and up written once (12 B a slot
// in f32), indptr, x[c] and ct (12 B a column) plus the gathers x[r_s];
// two multiplies and one add per slot.  Known limit: a long column
// serialises on one thread (FEM columns hold a few upper entries).
//
// B10 replaces repro/kernels/spmv_sym/spmv_sym.py:bsr_tiles
// (_bsr_tiles_kernel): for every stored b x b block k (row-major in
// data[k]) the partial product out[k, i] = sum_j data[k, i, j] *
// x[bcols[k] * b + j]; blocks whose block row is the sentinel (brows[k] >=
// Mb) write zeros.  The caller scatter-adds the partials into block rows.
// The TPU kernel keeps x resident in VMEM as (Nb, b) and contracts a tile
// of blocks per grid step; here one thread computes one (block, row) pair,
// so a warp covers 32 / b neighbouring blocks, reads their data
// contiguously and writes 32 consecutive outputs.  b is a template
// constant for 1, 2, 4 and 8 (the loop unrolls) and a runtime value
// otherwise.  Bound: bytes, data (4 b^2 nb B in f32), brows and bcols (8 nb
// B), x (4N B at least) and the output (4 b nb B); b multiplies and adds
// per output.  Both kernels round each product before adding it (no FMA
// contraction), as the plain versions round it.
#include <cstdint>
#include <cuda_runtime.h>

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
sym_streams_kernel(const int32_t* __restrict__ rows,
                   const T* __restrict__ data,
                   const int32_t* __restrict__ indptr,
                   const T* __restrict__ x, T* __restrict__ up,
                   T* __restrict__ ct, long long M) {
  const long long c = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (c >= M) return;
  const T xc = __ldg(x + c);
  const int end = __ldg(indptr + c + 1);
  T acc = T(0);
  for (int s = __ldg(indptr + c); s < end; ++s) {
    const int r = __ldg(rows + s);
    if (r >= 0 && r < M) {
      const T a = __ldg(data + s);
      up[s] = mul_rn(a, xc);
      acc += mul_rn(a, __ldg(x + r));
    } else {
      up[s] = T(0);
    }
  }
  ct[c] = acc;
}

template <typename T, int kB>
__global__ void __launch_bounds__(kThreads)
bsr_tiles_kernel(const int32_t* __restrict__ brows,
                 const int32_t* __restrict__ bcols,
                 const T* __restrict__ data, const T* __restrict__ x,
                 T* __restrict__ out, long long nb, long long Mb, int b_rt) {
  const int b = kB > 0 ? kB : b_rt;
  const long long t = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (t >= nb * b) return;
  const long long k = t / b;
  const int br = __ldg(brows + k);
  T acc = T(0);
  if (br >= 0 && br < Mb) {
    const T* d = data + t * b;  // row t % b of block k
    const T* xs = x + (long long)__ldg(bcols + k) * b;
#pragma unroll
    for (int j = 0; j < (kB > 0 ? kB : b); ++j)
      acc += mul_rn(__ldg(d + j), __ldg(xs + j));
  }
  out[t] = acc;
}

template <typename T>
int launch_sym(const void* rows, const void* data, const void* indptr,
               const void* x, void* up, void* ct, long long M, void* stream) {
  const long long blocks = (M + kThreads - 1) / kThreads;
  sym_streams_kernel<T><<<(unsigned)blocks, kThreads, 0,
                          (cudaStream_t)stream>>>(
      (const int32_t*)rows, (const T*)data, (const int32_t*)indptr,
      (const T*)x, (T*)up, (T*)ct, M);
  return (int)cudaGetLastError();
}

template <typename T, int kB>
void bsr_go(const void* brows, const void* bcols, const void* data,
            const void* x, void* out, long long nb, long long Mb, int b,
            cudaStream_t s) {
  const long long blocks = (nb * b + kThreads - 1) / kThreads;
  bsr_tiles_kernel<T, kB><<<(unsigned)blocks, kThreads, 0, s>>>(
      (const int32_t*)brows, (const int32_t*)bcols, (const T*)data,
      (const T*)x, (T*)out, nb, Mb, b);
}

template <typename T>
int launch_bsr(const void* brows, const void* bcols, const void* data,
               const void* x, void* out, long long nb, long long Mb, int b,
               void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  switch (b) {
    case 1: bsr_go<T, 1>(brows, bcols, data, x, out, nb, Mb, b, s); break;
    case 2: bsr_go<T, 2>(brows, bcols, data, x, out, nb, Mb, b, s); break;
    case 4: bsr_go<T, 4>(brows, bcols, data, x, out, nb, Mb, b, s); break;
    case 8: bsr_go<T, 8>(brows, bcols, data, x, out, nb, Mb, b, s); break;
    default: bsr_go<T, 0>(brows, bcols, data, x, out, nb, Mb, b, s); break;
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int sym_streams_f32_launch(const void* rows, const void* data,
                                      const void* indptr, const void* x,
                                      void* up, void* ct, long long M,
                                      void* stream) {
  return launch_sym<float>(rows, data, indptr, x, up, ct, M, stream);
}

extern "C" int sym_streams_f64_launch(const void* rows, const void* data,
                                      const void* indptr, const void* x,
                                      void* up, void* ct, long long M,
                                      void* stream) {
  return launch_sym<double>(rows, data, indptr, x, up, ct, M, stream);
}

extern "C" int bsr_tiles_f32_launch(const void* brows, const void* bcols,
                                    const void* data, const void* x,
                                    void* out, long long nb, long long Mb,
                                    int b, void* stream) {
  return launch_bsr<float>(brows, bcols, data, x, out, nb, Mb, b, stream);
}

extern "C" int bsr_tiles_f64_launch(const void* brows, const void* bcols,
                                    const void* data, const void* x,
                                    void* out, long long nb, long long Mb,
                                    int b, void* stream) {
  return launch_bsr<double>(brows, bcols, data, x, out, nb, Mb, b, stream);
}
