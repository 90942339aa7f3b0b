// B12: per-block histogram of bounded int32 keys (Part 1 of the paper's
// counting-sort planner, method="pallas").
//
// Replaces repro/kernels/hist/hist.py:block_histogram (_hist_kernel):
// hist[b, k] = number of keys equal to k among keys [b * block_b,
// (b + 1) * block_b), for 0 <= k < nbins; keys outside [0, nbins) count
// nowhere.  The TPU kernel sums a one-hot [B, T] compare tile per bin
// tile, for its matrix unit; the card counts with atomics instead.
//
// What bounds it on the H100: bytes.  It reads the keys once (4L B) and
// writes the table once (4 * nbins * nblocks B; the caller's block size
// keeps that under 4L B plus one row).  One atomic add per key.
//
// While the nbins counters fit the shared memory a block can opt into
// (227 KB on the H100: up to 58,112 bins, so Table 4.1's 50,001), one
// CUDA block of 1024 threads takes one histogram block, counts in shared
// memory and writes its row once at the end: the paper's thread with its
// private counters.
//
// Above that (the 5e7 set has 10^6 + 1 bins: a 4 MB row, 48 rows, a
// 192 MB table) the rows live in device memory and what decides the time
// is where the atomic adds resolve.  The table is past the 50 MB L2, so
// an add whose row is not in the L2 is a read-modify-write of a sector
// in HBM.  The grid is therefore ordered by key: CUDA block c takes one
// contiguous chunk of kChunk keys inside one histogram block (block
// index = row * chunks_per_row + chunk, so a chunk never straddles a
// row, for any block_b), and blocks are dispatched in index order.  The
// blocks resident at one time (2 a multiprocessor: 264 x 16,384 = 4.3M
// keys) then cover at most about 5 rows (20 MB), and their adds (RED,
// no return value) resolve in the L2; each row is read in and written
// back about once.  The table is zeroed by a memset first, as before.
// Measured on the H100 at 5e7: 0.78 ms (from 3.27 with every row live),
// of it 0.06 the memset; halving or quartering the chunk moved it by 2%,
// doubling it (a 10-row window) cost 47%.  What is left is the L2's rate
// for 5e7 adds to scattered words (about 7e10 a second), not the bytes.
#include <cstdint>
#include <cuda_runtime.h>
#include "resources.cuh"

namespace {

constexpr int kThreads = 1024;
constexpr long long kChunk = 1 << 14;  // keys per CUDA block, global mode
constexpr int kUnroll = 4;             // loads in flight per thread

__global__ void __launch_bounds__(kThreads)
hist_shared_kernel(const int32_t* __restrict__ keys, int32_t* __restrict__ hist,
                   long long L, int nbins, long long block_b) {
  extern __shared__ int counts[];
  for (int k = threadIdx.x; k < nbins; k += kThreads) counts[k] = 0;
  __syncthreads();
  const long long b0 = (long long)blockIdx.x * block_b;
  const long long b1 = b0 + block_b < L ? b0 + block_b : L;
  for (long long i = b0 + threadIdx.x; i < b1; i += kThreads) {
    const int k = __ldg(keys + i);
    if (k >= 0 && k < nbins) atomicAdd(&counts[k], 1);
  }
  __syncthreads();
  int32_t* row = hist + (long long)blockIdx.x * nbins;
  for (int k = threadIdx.x; k < nbins; k += kThreads) row[k] = counts[k];
}

__global__ void __launch_bounds__(kThreads)
hist_global_kernel(const int32_t* __restrict__ keys, int32_t* __restrict__ hist,
                   long long L, int nbins, long long block_b, long long chunk,
                   long long chunks_per_row) {
  const long long rowi = blockIdx.x / chunks_per_row;
  const long long r0 = rowi * block_b;
  const long long c0 = r0 + (blockIdx.x % chunks_per_row) * chunk;
  long long c1 = c0 + chunk;
  if (c1 > r0 + block_b) c1 = r0 + block_b;
  if (c1 > L) c1 = L;
  int32_t* row = hist + rowi * nbins;
  for (long long i = c0 + threadIdx.x; i < c1;
       i += (long long)kThreads * kUnroll) {
    int k[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long j = i + (long long)u * kThreads;
      k[u] = j < c1 ? __ldg(keys + j) : -1;
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      if (k[u] >= 0 && k[u] < nbins) atomicAdd(row + k[u], 1);
  }
}

}  // namespace

extern "C" int smem_optin_bytes(void) {
  int dev = 0, bytes = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return -1;
  if (cudaDeviceGetAttribute(&bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             dev) != cudaSuccess)
    return -1;
  return bytes;
}

// shared != 0: counters in shared memory (needs 4 * nbins bytes of it).
extern "C" int block_histogram_launch(const void* keys, void* hist,
                                      long long L, int nbins,
                                      long long block_b, int nblocks,
                                      int shared, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (shared) {
    const size_t smem = (size_t)nbins * sizeof(int);
    int rc = (int)cudaFuncSetAttribute(
        hist_shared_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (rc) return rc;
    hist_shared_kernel<<<nblocks, kThreads, smem, s>>>(
        (const int32_t*)keys, (int32_t*)hist, L, nbins, block_b);
    return (int)cudaGetLastError();
  }
  int rc = (int)cudaMemsetAsync(hist, 0,
                                (size_t)nblocks * nbins * sizeof(int32_t), s);
  if (rc) return rc;
  // a row holds at most min(block_b, L) keys: the grid stays under L
  const long long span = block_b < L ? block_b : L;
  const long long chunk = span < kChunk ? span : kChunk;
  const long long per_row = (span + chunk - 1) / chunk;
  const long long grid = per_row * nblocks;
  hist_global_kernel<<<(unsigned)grid, kThreads, 0, s>>>(
      (const int32_t*)keys, (int32_t*)hist, L, nbins, block_b, chunk, per_row);
  return (int)cudaGetLastError();
}

// the shared-counter instance at Table 4.1 set 2's 50,001 bins
namespace {
const KernelResource kResources[] = {
    {"block_histogram_shared", (const void*)hist_shared_kernel, kThreads,
     50001LL * 4},
    {"block_histogram_global", (const void*)hist_global_kernel, kThreads, 0},
};
}  // namespace
REPRO_RESOURCE_TABLE(kResources)
