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
// What the simple design does about it: one CUDA block of 1024 threads
// per histogram block, the paper's thread with its private counters.
// While the nbins counters fit the shared memory a block can opt into
// (227 KB on the H100: up to 58,112 bins, so Table 4.1's 50,001), they
// live there and the row is written once at the end.  Above that (the
// 5e7 set has 10^6 + 1 bins) the launcher zeroes the table and kSplits
// CUDA blocks per histogram block add straight into its row in device
// memory with global atomics; the sums are exact in either order.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kSplits = 8;  // CUDA blocks per histogram block, global mode

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
                   long long L, int nbins, long long block_b) {
  const long long b0 = (long long)blockIdx.x * block_b;
  const long long b1 = b0 + block_b < L ? b0 + block_b : L;
  int32_t* row = hist + (long long)blockIdx.x * nbins;
  const long long step = (long long)kThreads * kSplits;
  for (long long i = b0 + (long long)blockIdx.y * kThreads + threadIdx.x;
       i < b1; i += step) {
    const int k = __ldg(keys + i);
    if (k >= 0 && k < nbins) atomicAdd(row + k, 1);
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
  hist_global_kernel<<<dim3(nblocks, kSplits), kThreads, 0, s>>>(
      (const int32_t*)keys, (int32_t*)hist, L, nbins, block_b);
  return (int)cudaGetLastError();
}
