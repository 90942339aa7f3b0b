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
// column's total is summed by itself.  Slots whose row is the sentinel
// (r_s < 0 or r_s >= M) add nothing and get up = 0, as does the padded
// tail past indptr[M]: the kernel writes every one of the nzmax slots.
//
// What bounds it on the H100: bytes.  rows and data read once and up
// written once (12 B a slot in float32), indptr, x[c] and ct (12 B a
// column), plus the gathers x[r_s], which the FEM matrix's rows keep in
// the L2; two multiplies and one add a slot.  In fact the latency of its
// dependent rounds: a column's ends, then its slots, then the gathers.
//
// It replaced one thread a column walking the column's slots one at a
// time behind a zeroing of up (kept in spmv_sym_probe.cu): a long column
// serialised on its thread (122 ms for a column of 2^20 on the H100).
// Two shapes now, one launch either way, chosen by the wrapper from the
// stream's longest column, which the caller passes (SymCSC.longest, found
// where the format is built; unknown: the tiles), and its mean:
//  - short columns (at most SHORT_COLUMN = 32 slots and SHORT_MEAN = 4 on
//    average, the crossings timed in PERF.md; the FEM matrix's strict
//    upper half holds 3 a column): one thread a column, its slots read 4 at
//    a time with every load issued before any use, and the padded tail
//    zeroed by the same launch (the wrapper zeroes nothing);
//  - any stream: Merrill and Garland's merge-based SpMV with B3''s carry.
//    The work is the merge of the column ends indptr[1..M] with the slots
//    0..nzmax-1 (slot s before column c's end iff s < indptr[c + 1]); a
//    tile is 256 threads x kSymPer (8) consecutive items of it, in ticket
//    order.
//     1. Warps 0 and 1 find where the tile's first and last diagonal
//        cross the merge (a 32-ary search of indptr[c + 1] + c + 1): the
//        tile owns the ends of columns [i0, i1) and the slots [j0, j1).
//     2. Load: ends, rows and values copied into shared memory with
//        cp.async (no registers held), then each thread's 8 gathers
//        x[r_s] issued before any is used; a_s * x[r_s] (rounded, no FMA)
//        into shared memory.
//     3. Each thread finds its own diagonal in shared memory (a binary
//        search) and walks its 8 items: a slot adds its product to the run
//        of the open column and records its column; an end closes the
//        column, whose total is the run unless the column began before
//        the thread (the thread's first end), whose run waits.
//     4. The runs open at each thread's end go through B3''s segmented
//        warp scan and pass over the warps.  A column open at the tile's
//        start that began at most 32 slots before it is read again by
//        warp 0 (its products added in a fixed tree); a longer one comes
//        from the decoupled look-back of lookback.cuh (prefix published
//        at once where the tile closes a column; a tile inside one column
//        publishes its aggregate).  A column of any length is summed by
//        all the tiles it spans.
//     5. Write, striped: up[s] = a_s * x[c_s] (its gathers issued before
//        the carry) and the tile's column totals.
//    The tiles at other depths and with phase stamps are timed in
//    spmv_sym_probe.cu.
// Every order of additions is fixed by the data (and by the tile ids), so
// ct is bit-identical from call to call; on integer-valued data below 2^24
// (2^53 in float64) it is exact.  In the tiles a total of m terms is
// within (K + 12) eps / 2 sum|terms| of the exact sum to first order (K =
// 8: 10 eps), as B3''s, at any column length; one thread a column adds at
// most 32 terms in order.  up is one rounded product a slot.
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
#include "resources.cuh"

#include "lookback.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ float mul_rn(float a, float b) {
  return __fmul_rn(a, b);
}
__device__ __forceinline__ double mul_rn(double a, double b) {
  return __dmul_rn(a, b);
}

// -- B9 ---------------------------------------------------------------------
// A 4- or 8-byte copy from device to shared memory that holds no register
// (cp.async, cached at all levels); the caller commits and waits.
template <typename T>
__device__ __forceinline__ void copy_async(T* smem, const T* gmem) {
  static_assert(sizeof(T) == 4 || sizeof(T) == 8, "4 or 8 bytes");
  const unsigned dst = (unsigned)__cvta_generic_to_shared(smem);
  if (sizeof(T) == 4) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;"
                 :: "r"(dst), "l"(gmem) : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;"
                 :: "r"(dst), "l"(gmem) : "memory");
  }
}

// merge items a thread; the tile is kThreads x kSymPer
constexpr int kSymPer = 8;
// resident tiles an SM should hold (registers capped to fit them)
template <typename T>
constexpr int kSymMinBlocks = sizeof(T) == 4 ? 8 : 4;
// a carry into the tile of at most this many slots is summed again from
// the stream by warp 0 instead of waiting on the look-back
constexpr int kSymRecompute = 32;

// A whole warp: the number of columns c < M whose end item comes before
// merge diagonal d (indptr[c + 1] + c + 1 <= d, increasing in c).
__device__ long long merge_path(const int32_t* __restrict__ indptr,
                                long long M, long long d) {
  const int lane = threadIdx.x & 31;
  long long lo = 0, hi = M;
  while (hi - lo > 32) {
    const long long span = hi - lo;
    long long p = 0;
    bool b = false;
    if (lane < 31) {
      p = lo + ((span * (lane + 1)) >> 5);
      b = __ldg(indptr + p + 1) + p + 1 <= d;
    }
    const int j = __popc(__ballot_sync(0xffffffffu, b));
    const long long pl = __shfl_sync(0xffffffffu, p, j > 0 ? j - 1 : 0);
    const long long ph = __shfl_sync(0xffffffffu, p, j < 31 ? j : 30);
    if (j > 0) lo = pl + 1;
    if (j < 31) hi = ph;
  }
  bool b = false;
  if (lane < hi - lo) b = __ldg(indptr + lo + lane + 1) + lo + lane + 1 <= d;
  return lo + __popc(__ballot_sync(0xffffffffu, b));
}

// The merge-path tiles (the head of this file).
template <typename T, typename Desc>
__global__ void __launch_bounds__(kThreads, kSymMinBlocks<T>)
sym_streams_kernel(const int32_t* __restrict__ rows,
                   const T* __restrict__ data,
                   const int32_t* __restrict__ indptr,
                   const T* __restrict__ x, T* __restrict__ up,
                   T* __restrict__ ct, long long M, long long nzmax,
                   int* __restrict__ ticket, Desc desc) {
  constexpr int K = kSymPer;
  constexpr int D = kThreads * K;
  using Op = SumOp<T>;
  using Acc = typename Op::Acc;
  // the tile's column ends [0, ni), then a word per slot [ni, ni + nj):
  // -1 for a slot that adds nothing, then the slot's column
  __shared__ int32_t s_idx[D];
  // the slots' values [0, nj), then the column totals [nj, nj + ni)
  __shared__ T s_val[D];
  __shared__ T s_lo[D];  // a_s * x[r_s]
  __shared__ int warp_f[kWarps];
  __shared__ T warp_v[kWarps];
  __shared__ Acc look[kLookWindows][32];
  __shared__ Acc excl_s;
  __shared__ long long coord_s[2];
  __shared__ int tile_s;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  if (t == 0) tile_s = atomicAdd(ticket, 1);  // the order of the chain
  __syncthreads();
  const int id = tile_s;
  const long long d0 = (long long)id * D;
  const long long d1 = min(d0 + D, M + nzmax);
  // -- 1. where the tile's edges cross the merge ----------------------------
  if (warp < 2) {
    const long long i = merge_path(indptr, M, warp == 0 ? d0 : d1);
    if (lane == 0) coord_s[warp] = i;
  }
  __syncthreads();
  const long long i0 = coord_s[0], i1 = coord_s[1];
  const long long j0 = d0 - i0;
  const int ni = (int)(i1 - i0), nj = (int)(d1 - i1 - j0);

  // -- 2. load: the ends, rows and values copied to shared memory
  //    asynchronously (no registers held), then the gathers x[r] ----------
#pragma unroll
  for (int q = 0; q < K; ++q) {
    const int k = q * kThreads + t;
    if (k < ni) copy_async(s_idx + k, indptr + i0 + 1 + k);
    if (k < nj) {
      copy_async(s_idx + ni + k, rows + j0 + k);
      copy_async(s_val + k, data + j0 + k);
    }
  }
  asm volatile("cp.async.commit_group;" ::: "memory");
  // the column open at the tile's start began `carried` slots before it
  // (tile 0 and a column starting at j0 carry nothing); a short carry's
  // slots are read again by warp 0, one a lane, and their products are
  // formed after the walk
  const long long carried =
      warp == 0 && i0 < M ? j0 - __ldg(indptr + i0) : 0;
  int32_t rc = -1;
  T ac = T(0), xrc = T(0);
  if (warp == 0 && carried > 0 && carried <= kSymRecompute && lane < carried) {
    rc = __ldg(rows + j0 - carried + lane);
    ac = __ldg(data + j0 - carried + lane);
  }
  asm volatile("cp.async.wait_all;" ::: "memory");
  __syncthreads();
  {
    T xr[K];
#pragma unroll
    for (int q = 0; q < K; ++q) {  // all K gathers before any use
      const int k = q * kThreads + t;
      const int32_t r = k < nj ? s_idx[ni + k] : -1;
      xr[q] = (r >= 0 && r < M) ? __ldg(x + r) : T(0);
    }
#pragma unroll
    for (int q = 0; q < K; ++q) {
      const int k = q * kThreads + t;
      if (k < nj) {
        const int32_t r = s_idx[ni + k];
        const bool valid = r >= 0 && r < M;
        s_idx[ni + k] = valid ? 0 : -1;
        s_lo[k] = valid ? mul_rn(s_val[k], xr[q]) : T(0);
      }
    }
  }
  if (rc >= 0 && rc < M) xrc = __ldg(x + rc);
  __syncthreads();

  // -- 3. each thread's items: its diagonal, then the walk -----------------
  const int dl = min(t * K, ni + nj);
  int ci = max(0, dl - nj), hi = min(dl, ni);
  while (ci < hi) {  // ends before slot dl - m - 1 of the tile
    const int m = (ci + hi) >> 1;
    if (s_idx[m] <= j0 + (dl - m - 1)) {
      ci = m + 1;
    } else {
      hi = m;
    }
  }
  int cj = dl - ci;
  const int items = min(K, ni + nj - dl);
  T run = T(0), first_run = T(0);
  int first = -1;  // the thread's first end: its column's run waits
#pragma unroll
  for (int q = 0; q < K; ++q) {
    if (q < items) {
      if (ci < ni && (cj >= nj || s_idx[ci] <= j0 + cj)) {
        if (first < 0) {
          first = ci;
          first_run = run;
        } else {
          s_val[nj + ci] = run;
        }
        run = T(0);
        ++ci;
      } else {
        run += s_lo[cj];
        if (s_idx[ni + cj] == 0) s_idx[ni + cj] = i0 + ci < M ? ci : -1;
        ++cj;
      }
    }
  }

  // -- 4. the runs open at the threads' ends, across the tile and tiles ---
  int f = first >= 0;
  T v = run;
  warp_segscan<Op>(f, v);
  int fx = __shfl_up_sync(0xffffffffu, f, 1);
  T vx = __shfl_up_sync(0xffffffffu, v, 1);
  if (lane == 0) {
    fx = 0;
    vx = T(0);
  }
  if (lane == 31) {
    warp_f[warp] = f;
    warp_v[warp] = v;
  }
  __syncthreads();
  // every slot's column is recorded: the gathers of up's x[c] go out now
  T xc[K];
#pragma unroll
  for (int q = 0; q < K; ++q) {
    const int k = q * kThreads + t;
    const int c = k < nj ? s_idx[ni + k] : -1;
    xc[q] = c >= 0 ? __ldg(x + i0 + c) : T(0);
  }
  int fb = 0, F = 0;
  T vb = T(0), A = T(0);
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    const int fw = warp_f[w];
    const T yw = warp_v[w];
    if (w < warp) {
      vb = fw ? yw : vb + yw;
      fb |= fw;
    }
    A = fw ? yw : A + yw;
    F |= fw;
  }
  const int fe = fb | fx;                // a column closed before the thread
  const T ce = fx ? vx : vb + vx;        // the run open at its start
  if (warp == 0) {
    if (carried <= kSymRecompute) {
      // the carry is known: the products read again, added in a fixed
      // tree (0 where nothing is carried)
      T again = rc >= 0 && rc < M ? mul_rn(ac, xrc) : T(0);
#pragma unroll
      for (int d = 16; d > 0; d >>= 1)
        again += __shfl_xor_sync(0xffffffffu, again, d);
      const Acc e = Op::of(again);
      if (lane == 0) {
        desc.publish(id, kPrefix, F ? Op::of(A) : Op::combine(e, Op::of(A)));
        excl_s = e;
      }
    } else {
      // a long carry: the look-back chains it through the tiles before
      if (lane == 0) desc.publish(id, F ? kPrefix : kAggregate, Op::of(A));
      Acc e;
      look_back<Op>(desc, id, look, e);
      if (lane == 0) {
        if (!F) desc.publish(id, kPrefix, Op::combine(e, Op::of(A)));
        excl_s = e;
      }
    }
  }
  __syncthreads();
  if (first >= 0) {
    Acc carry = Op::of(ce);
    if (!fe) carry = Op::combine(excl_s, carry);
    s_val[nj + first] = Op::value(Op::combine(carry, Op::of(first_run)));
  }
  __syncthreads();

  // -- 5. write the slots' up and the tile's column totals, striped -------
#pragma unroll
  for (int q = 0; q < K; ++q) {
    const int k = q * kThreads + t;
    if (k < nj)
      up[j0 + k] = s_idx[ni + k] >= 0 ? mul_rn(s_val[k], xc[q]) : T(0);
  }
  for (int k = t; k < ni; k += kThreads) ct[i0 + k] = s_val[nj + k];
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

// -- B9, the short-column shape ---------------------------------------------
// One thread a column: its ends and x[c], then its slots kRun at a time
// (every load of a step before any use), a running total in slot order.
// The threads then write zeros over the padded tail past indptr[M],
// striped, so the wrapper zeroes nothing.
constexpr int kRun = 4;

template <typename T>
__global__ void __launch_bounds__(kThreads)
sym_threads_kernel(const int32_t* __restrict__ rows,
                   const T* __restrict__ data,
                   const int32_t* __restrict__ indptr,
                   const T* __restrict__ x, T* __restrict__ up,
                   T* __restrict__ ct, long long M, long long nzmax) {
  const long long c = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (c < M) {
    const int s0 = __ldg(indptr + c), s1 = __ldg(indptr + c + 1);
    const T xc = __ldg(x + c);
    T acc = T(0);
    for (int b = s0; b < s1; b += kRun) {
      int32_t r[kRun];
      T a[kRun], xr[kRun];
#pragma unroll
      for (int k = 0; k < kRun; ++k) {
        r[k] = b + k < s1 ? __ldg(rows + b + k) : -1;
        a[k] = b + k < s1 ? __ldg(data + b + k) : T(0);
      }
#pragma unroll
      for (int k = 0; k < kRun; ++k)
        xr[k] = (r[k] >= 0 && r[k] < M) ? __ldg(x + r[k]) : T(0);
#pragma unroll
      for (int k = 0; k < kRun; ++k) {
        if (b + k < s1) {
          const bool valid = r[k] >= 0 && r[k] < M;
          up[b + k] = valid ? mul_rn(a[k], xc) : T(0);
          if (valid) acc += mul_rn(a[k], xr[k]);
        }
      }
    }
    ct[c] = acc;
  }
  const long long E = __ldg(indptr + M);
  const long long stride = (long long)gridDim.x * kThreads;
  for (long long sl = E + c; sl < nzmax; sl += stride) up[sl] = T(0);
}

template <typename T>
int launch_threads(const void* rows, const void* data, const void* indptr,
                   const void* x, void* up, void* ct, long long M,
                   long long nzmax, void* stream) {
  const long long blocks = (M + kThreads - 1) / kThreads;
  sym_threads_kernel<T><<<(unsigned)blocks, kThreads, 0,
                          (cudaStream_t)stream>>>(
      (const int32_t*)rows, (const T*)data, (const int32_t*)indptr,
      (const T*)x, (T*)up, (T*)ct, M, nzmax);
  return (int)cudaGetLastError();
}

// scratch: 1 + 2 ntiles (float32) or 1 + 4 ntiles (float64) zeroed
// 64-bit words, ntiles = ceil((M + nzmax) / (kThreads * kSymPer)): the
// tile ticket, then the descriptors
template <typename T>
int launch_sym(const void* rows, const void* data, const void* indptr,
               const void* x, void* up, void* ct, void* scratch, long long M,
               long long nzmax, void* stream) {
  const long long ntiles =
      (M + nzmax + kThreads * kSymPer - 1) / (kThreads * kSymPer);
  unsigned long long* w = (unsigned long long*)scratch;
  sym_streams_kernel<T, decltype(DescOf<T>::at(w, ntiles))>
      <<<(unsigned)ntiles, kThreads, 0, (cudaStream_t)stream>>>(
          (const int32_t*)rows, (const T*)data, (const int32_t*)indptr,
          (const T*)x, (T*)up, (T*)ct, M, nzmax, (int*)w,
          DescOf<T>::at(w, ntiles));
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

// shape: 0 the merge-path tiles (any stream; scratch as launch_sym's),
// 1 one thread a column (for short columns; scratch unused)
extern "C" int sym_streams_f32_launch(const void* rows, const void* data,
                                      const void* indptr, const void* x,
                                      void* up, void* ct, void* scratch,
                                      long long M, long long nzmax, int shape,
                                      void* stream) {
  return shape ? launch_threads<float>(rows, data, indptr, x, up, ct, M,
                                       nzmax, stream)
               : launch_sym<float>(rows, data, indptr, x, up, ct, scratch, M,
                                   nzmax, stream);
}

extern "C" int sym_streams_f64_launch(const void* rows, const void* data,
                                      const void* indptr, const void* x,
                                      void* up, void* ct, void* scratch,
                                      long long M, long long nzmax, int shape,
                                      void* stream) {
  return shape ? launch_threads<double>(rows, data, indptr, x, up, ct, M,
                                        nzmax, stream)
               : launch_sym<double>(rows, data, indptr, x, up, ct, scratch,
                                    M, nzmax, stream);
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

// merge items a tile: the shape ref.py's sym_streams_tiled_ref follows
extern "C" int sym_tile(void) { return kThreads * kSymPer; }

// B9's two shapes and B10 at 2 x 2 blocks (the FEM matrix's)
namespace {
template <typename T>
using DescT = decltype(DescOf<T>::at(nullptr, 0));
const KernelResource kResources[] = {
    {"sym_streams_tiles_f32",
     (const void*)sym_streams_kernel<float, DescT<float>>, kThreads, 0},
    {"sym_streams_tiles_f64",
     (const void*)sym_streams_kernel<double, DescT<double>>, kThreads, 0},
    {"sym_streams_columns_f32", (const void*)sym_threads_kernel<float>,
     kThreads, 0},
    {"sym_streams_columns_f64", (const void*)sym_threads_kernel<double>,
     kThreads, 0},
    {"bsr_tiles_b2_f32", (const void*)bsr_tiles_kernel<float, 2>, kThreads,
     0},
    {"bsr_tiles_b2_f64", (const void*)bsr_tiles_kernel<double, 2>, kThreads,
     0},
};
}  // namespace
REPRO_RESOURCE_TABLE(kResources)
