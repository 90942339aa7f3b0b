// Timing probes of B9 (csrc/spmv_sym.cu), for comparison only: nothing in
// the port calls them.  chip_smoke.py and kernel_times.py time them beside
// the kernel.
//
//  - The design B9 replaced (the first port): one thread a column walks the
//    column's slots one at a time, writes up for each and the column's
//    total once (its wrapper zeroed up first; the timing zeroes it too).
//    A long column serialises on its thread.
//  - B9's merge-path tiles at other depths (4 and 12 merge items a
//    thread) and with every carry into a tile taken from the look-back
//    (none summed again), and with phase stamps: thread 0 of each tile
//    writes the device clock (%globaltimer, ns) at its start, after the
//    ticket, the search, the loads, the walk, the carry and the writes.
//    They run a copy of the tile kernel's body with these choices as
//    template parameters (the shipped kernel is fixed to its own).
//  - A shape that lost to one thread a column on short columns: a warp
//    takes 32 consecutive columns and their contiguous slots, 128 a step,
//    a slot's column found among the group's ends in shared memory and
//    the products reduced by a segmented warp scan (coalesced, 42
//    registers).
#include "spmv_sym.cu"

namespace {

template <typename T>
__global__ void __launch_bounds__(kThreads)
legacy_sym_streams_kernel(const int32_t* __restrict__ rows,
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

// -- the tiles at other depths, and with phase stamps ---------------------
// The device clock, for the timing probe's phase stamps.
__device__ __forceinline__ unsigned long long clock_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// B9's merge-path tiles with their choices as template parameters: K merge
// items a thread, kMinBlocks resident tiles an SM, a carry of at most kRe
// slots summed again, and with kStamp thread 0 writing the clock at its
// start to stamps[8 id + 6] and after the ticket and each phase to
// stamps[8 id .. 8 id + 5].  Otherwise the body of B9's tile kernel.
template <typename T, int K, typename Desc, bool kStamp = false,
          int kMinBlocks = kSymMinBlocks<T>, int kRe = kSymRecompute>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
variant_streams_kernel(const int32_t* __restrict__ rows,
                       const T* __restrict__ data,
                       const int32_t* __restrict__ indptr,
                       const T* __restrict__ x, T* __restrict__ up,
                       T* __restrict__ ct, long long M, long long nzmax,
                       int* __restrict__ ticket, Desc desc,
                       unsigned long long* __restrict__ stamps = nullptr) {
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
  const unsigned long long born = kStamp ? clock_ns() : 0;
  if (t == 0) tile_s = atomicAdd(ticket, 1);  // the order of the chain
  __syncthreads();
  const int id = tile_s;
  const long long d0 = (long long)id * D;
  const long long d1 = min(d0 + D, M + nzmax);
  if (kStamp && t == 0) {
    stamps[8 * id] = clock_ns();
    stamps[8 * id + 6] = born;
  }
  // -- 1. where the tile's edges cross the merge ----------------------------
  if (warp < 2) {
    const long long i = merge_path(indptr, M, warp == 0 ? d0 : d1);
    if (lane == 0) coord_s[warp] = i;
  }
  __syncthreads();
  const long long i0 = coord_s[0], i1 = coord_s[1];
  const long long j0 = d0 - i0;
  const int ni = (int)(i1 - i0), nj = (int)(d1 - i1 - j0);
  if (kStamp && t == 0) stamps[8 * id + 1] = clock_ns();

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
  if (warp == 0 && carried > 0 && carried <= kRe && lane < carried) {
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
  if (kStamp && t == 0) stamps[8 * id + 2] = clock_ns();

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
  if (kStamp && t == 0) stamps[8 * id + 3] = clock_ns();
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
    if (carried <= kRe) {
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
  if (kStamp && t == 0) stamps[8 * id + 4] = clock_ns();

  // -- 5. write the slots' up and the tile's column totals, striped -------
#pragma unroll
  for (int q = 0; q < K; ++q) {
    const int k = q * kThreads + t;
    if (k < nj)
      up[j0 + k] = s_idx[ni + k] >= 0 ? mul_rn(s_val[k], xc[q]) : T(0);
  }
  for (int k = t; k < ni; k += kThreads) ct[i0 + k] = s_val[nj + k];
  if (kStamp) {
    __syncthreads();
    if (t == 0) stamps[8 * id + 5] = clock_ns();
  }
}

// scratch as launch_sym's, for tiles of kThreads x K items
template <typename T, int K = kSymPer, bool kStamp = false,
          int kMinBlocks = kSymMinBlocks<T>, int kRe = kSymRecompute>
int launch_variant(const void* rows, const void* data, const void* indptr,
                   const void* x, void* up, void* ct, void* scratch,
                   long long M, long long nzmax, void* stream,
                   void* stamps = nullptr) {
  const long long ntiles = (M + nzmax + kThreads * K - 1) / (kThreads * K);
  unsigned long long* w = (unsigned long long*)scratch;
  variant_streams_kernel<T, K, decltype(DescOf<T>::at(w, ntiles)), kStamp,
                         kMinBlocks, kRe>
      <<<(unsigned)ntiles, kThreads, 0, (cudaStream_t)stream>>>(
          (const int32_t*)rows, (const T*)data, (const int32_t*)indptr,
          (const T*)x, (T*)up, (T*)ct, M, nzmax, (int*)w,
          DescOf<T>::at(w, ntiles), (unsigned long long*)stamps);
  return (int)cudaGetLastError();
}

// -- the column-group shape -------------------------------------------------
constexpr int kChunks = 4;

template <typename T>
__device__ __forceinline__ typename Chain<T>::Acc shfl_acc(
    typename Chain<T>::Acc v, int src) {
  return __shfl_sync(0xffffffffu, v, src);
}
template <>
__device__ __forceinline__ Chain<double>::Acc shfl_acc<double>(
    Chain<double>::Acc v, int src) {
  return {__shfl_sync(0xffffffffu, v.hi, src),
          __shfl_sync(0xffffffffu, v.lo, src)};
}

// A warp's work on group c0: the slots [ends[0], ends[32]) with the
// group's 33 ends in shared memory and x[c0 + lane] in xc.
template <typename T, int kC>
__device__ __forceinline__ void group_body(const int32_t* __restrict__ rows,
                                           const T* __restrict__ data,
                                           const T* __restrict__ x,
                                           T* __restrict__ up,
                                           T* __restrict__ ct, long long M,
                                           long long nzmax,
                                           const int32_t* ends, T xc,
                                           long long c0) {
  using Op = SumOp<T>;
  using Acc = typename Op::Acc;
  const int lane = threadIdx.x & 31;
  const long long c = c0 + lane;
  if (c < M && ends[lane] == ends[lane + 1]) ct[c] = T(0);  // empty
  const long long A = ends[0], B = ends[32];
  Acc carry = Op::of(T(0));
  int carry_lc = -1;  // the group column whose run is open, -1: none
  for (long long base = A; base < B; base += 32 * kC) {
    // -- rows and values, then the gathers: all before any use ------------
    int32_t r[kC];
    T a[kC], xr[kC];
#pragma unroll
    for (int k = 0; k < kC; ++k) {
      const long long sl = base + 32 * k + lane;
      r[k] = sl < B ? __ldcs(rows + sl) : -1;
      a[k] = sl < B ? __ldcs(data + sl) : T(0);
    }
#pragma unroll
    for (int k = 0; k < kC; ++k)
      xr[k] = (r[k] >= 0 && r[k] < M) ? __ldg(x + r[k]) : T(0);
#pragma unroll
    for (int k = 0; k < kC; ++k) {
      if (base + 32 * k >= B) break;  // the same for the whole warp
      const long long sl = base + 32 * k + lane;
      const bool in = sl < B;
      // the slot's group column: the ends at or below it
      int lo = 0, hi = 32;
      while (lo < hi) {
        const int m = (lo + hi) >> 1;
        if (ends[m + 1] <= sl) {
          lo = m + 1;
        } else {
          hi = m;
        }
      }
      const int lc = in ? lo : 32;
      const T xcol = __shfl_sync(0xffffffffu, xc, lc & 31);
      const bool valid = in && r[k] >= 0 && r[k] < M && c0 + lc < M;
      if (in) up[sl] = valid ? mul_rn(a[k], xcol) : T(0);
      T v = valid ? mul_rn(a[k], xr[k]) : T(0);
      const int prev = __shfl_up_sync(0xffffffffu, lc, 1);
      int f = lane == 0 ? lc != carry_lc : lc != prev;
      warp_segscan<Op>(f, v);
      // a run that began in an earlier step takes the carry
      const Acc total = f ? Op::of(v) : Op::combine(carry, Op::of(v));
      if (in && c0 + lc < M && sl == (long long)ends[lc + 1] - 1)
        ct[c0 + lc] = Op::value(Op::combine(Op::of(T(0)), total));
      carry = shfl_acc<T>(total, 31);
      carry_lc = __shfl_sync(0xffffffffu, lc, 31);
    }
  }
  // the last group zeroes the padded tail past indptr[M]
  if (c0 + 32 >= M)
    for (long long sl = B + lane; sl < nzmax; sl += 32) up[sl] = T(0);
}

// The group's ends (lane l: indptr[min(c0 + l + 1, M)], lane 0 also
// indptr[c0]) and x[c0 + l]: loads only, used later.
template <typename T>
__device__ __forceinline__ void group_head(const int32_t* __restrict__ indptr,
                                           const T* __restrict__ x,
                                           long long M, long long c0,
                                           int32_t& e_hi, int32_t& e_lo,
                                           T& xc) {
  const int lane = threadIdx.x & 31;
  const long long c = c0 + lane;
  e_hi = __ldg(indptr + min(c + 1, M));
  e_lo = lane == 0 ? __ldg(indptr + c0) : 0;
  xc = c < M ? __ldg(x + c) : T(0);
}

// One group a warp (the grid covers every group).
template <typename T, int kC = kChunks>
__global__ void __launch_bounds__(kThreads)
sym_columns_kernel(const int32_t* __restrict__ rows,
                   const T* __restrict__ data,
                   const int32_t* __restrict__ indptr,
                   const T* __restrict__ x, T* __restrict__ up,
                   T* __restrict__ ct, long long M, long long nzmax) {
  __shared__ int32_t s_end[kWarps][33];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long c0 = ((long long)blockIdx.x * kWarps + warp) * 32;
  if (c0 >= M) return;
  int32_t e_hi, e_lo;
  T xc;
  group_head(indptr, x, M, c0, e_hi, e_lo, xc);
  int32_t* ends = s_end[warp];
  if (lane == 0) ends[0] = e_lo;
  ends[lane + 1] = e_hi;
  __syncwarp();
  group_body<T, kC>(rows, data, x, up, ct, M, nzmax, ends, xc, c0);
}

template <typename T, int kC = kChunks>
int launch_columns(const void* rows, const void* data, const void* indptr,
                   const void* x, void* up, void* ct, long long M,
                   long long nzmax, void* stream) {
  const long long blocks = (M + 32 * kWarps - 1) / (32 * kWarps);
  sym_columns_kernel<T, kC><<<(unsigned)blocks, kThreads, 0,
                              (cudaStream_t)stream>>>(
      (const int32_t*)rows, (const T*)data, (const int32_t*)indptr,
      (const T*)x, (T*)up, (T*)ct, M, nzmax);
  return (int)cudaGetLastError();
}

}  // namespace

// float32.  variant: 0 the replaced design (up must hold zeros: the
// slots it does not visit keep them; scratch unused), 1 the merge-path
// tiles as shipped (K = 8), 2 K = 4, 3 K = 12 (5 tiles an SM), 4 every
// carry through the look-back, 5 the column groups, 6 one thread a column
// as shipped (scratch sized for the variant's tiles; unused by 0, 5, 6).
extern "C" int probe_sym_streams_f32_launch(int variant, const void* rows,
                                            const void* data,
                                            const void* indptr,
                                            const void* x, void* up,
                                            void* ct, void* scratch,
                                            long long M, long long nzmax,
                                            void* stream) {
  switch (variant) {
    case 0: {
      const long long blocks = (M + kThreads - 1) / kThreads;
      legacy_sym_streams_kernel<float><<<(unsigned)blocks, kThreads, 0,
                                         (cudaStream_t)stream>>>(
          (const int32_t*)rows, (const float*)data, (const int32_t*)indptr,
          (const float*)x, (float*)up, (float*)ct, M);
      return (int)cudaGetLastError();
    }
    case 1:
      return launch_sym<float>(rows, data, indptr, x, up, ct, scratch, M,
                               nzmax, stream);
    case 2:
      return launch_variant<float, 4>(rows, data, indptr, x, up, ct, scratch,
                                      M, nzmax, stream);
    case 3:
      return launch_variant<float, 12, false, 5>(rows, data, indptr, x, up,
                                                 ct, scratch, M, nzmax,
                                                 stream);
    case 4:
      return launch_variant<float, kSymPer, false, 8, 0>(
          rows, data, indptr, x, up, ct, scratch, M, nzmax, stream);
    case 5:
      return launch_columns<float>(rows, data, indptr, x, up, ct, M, nzmax,
                                   stream);
    case 6:
      return launch_threads<float>(rows, data, indptr, x, up, ct, M, nzmax,
                                   stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// merge items a tile of each variant (0: no tiles)
extern "C" long long probe_sym_tile(int variant) {
  const int per[] = {0, kSymPer, 4, 12, kSymPer, 0, 0};
  return variant >= 0 && variant < 7 ? (long long)kThreads * per[variant]
                                     : 0;
}

// B9's merge-path tiles as shipped with their phase stamps: stamps holds
// 8 words a tile
extern "C" int probe_sym_streams_stamped_f32_launch(
    const void* rows, const void* data, const void* indptr, const void* x,
    void* up, void* ct, void* scratch, long long M, long long nzmax,
    void* stamps, void* stream) {
  return launch_variant<float, kSymPer, true>(rows, data, indptr, x, up, ct,
                                              scratch, M, nzmax, stream,
                                              stamps);
}
