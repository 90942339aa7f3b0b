// B11: stable counting-sort placement (Part 2 of the paper's planner,
// method="pallas").
//
// Replaces repro/kernels/counting_sort/counting_sort.py:placement
// (_placement_kernel): pos[i] = offsets[b, key_i] + (the number of keys
// equal to key_i earlier in block b), where b = i / block_b and
// offsets[nblocks, nbins] comes from B12 and two scans
// (hist/ops.py:block_offsets).  That is the paper's placement loop
// rank[jrS[ii[i]]++] = i with one private counter row jrS per block.
// The TPU kernel gathers the base with a one-hot matvec and counts the
// earlier equal keys with a [B, B] equality tile, both for its matrix
// unit; neither has a place here.
//
// What bounds it on the H100: not bytes (it reads the keys once, 4L B,
// the table once, 4 * nbins * nblocks B, and writes 4L B) but the
// order: the count of earlier equal keys makes the keys of one block a
// chain.  One warp per block walks its keys in input order, 32 at a
// time: __match_any_sync groups the lanes holding equal keys, a lane's
// position is its key's counter plus the equal keys in lower lanes
// (__popc(peers & lanemask_lt)), and the lowest of them advances the
// counter.  Lane and step order are input order, so the sort is stable
// (B2's ranking, csrc/radix_sort.cu).  The counter row is block b's own
// row of offsets: copied to shared memory by the whole CUDA block when
// 4 * nbins bytes fit (Table 4.1's 50,001 bins do), else a per-block
// copy in device memory that the caller provides (the 5e7 set's 10^6 + 1
// bins), where each step waits on a round trip to the L2.  The next
// step's keys are loaded before the current step's counters, so the
// key reads overlap the chain.  Parallelism is one warp per block, so
// the caller's block size trades the table's size against the number of
// chains.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;  // all of them load the row; warp 0 places

__device__ __forceinline__ int key_at(const int32_t* __restrict__ keys,
                                      long long i, long long end,
                                      int nbins) {
  if (i >= end) return -1;
  const int k = __ldg(keys + i);
  return (k >= 0 && k < nbins) ? k : -1;  // out of contract: not placed
}

__device__ __forceinline__ void place_block(const int32_t* __restrict__ keys,
                                            volatile int* cnt,
                                            int32_t* __restrict__ pos,
                                            long long b0, long long b1,
                                            int nbins) {
  const int lane = threadIdx.x & 31;
  const unsigned lanemask_lt = (1u << lane) - 1u;
  int k = key_at(keys, b0 + lane, b1, nbins);
  for (long long base = b0; base < b1; base += 32) {
    const int k_next = key_at(keys, base + 32 + lane, b1, nbins);
    const unsigned peers = __match_any_sync(0xffffffffu, k);
    int c = 0;
    if (k >= 0) {
      c = cnt[k];
      pos[base + lane] = c + __popc(peers & lanemask_lt);
    } else if (base + lane < b1) {
      pos[base + lane] = -1;
    }
    __syncwarp();
    if (k >= 0 && lane == __ffs(peers) - 1) cnt[k] = c + __popc(peers);
    __syncwarp();
    k = k_next;
  }
}

__global__ void __launch_bounds__(kThreads)
placement_shared_kernel(const int32_t* __restrict__ keys,
                        const int32_t* __restrict__ offsets,
                        int32_t* __restrict__ pos, long long L, int nbins,
                        long long block_b) {
  extern __shared__ int cnt[];
  const int32_t* row = offsets + (long long)blockIdx.x * nbins;
  for (int k = threadIdx.x; k < nbins; k += kThreads) cnt[k] = __ldg(row + k);
  __syncthreads();
  if (threadIdx.x >= 32) return;
  const long long b0 = (long long)blockIdx.x * block_b;
  const long long b1 = b0 + block_b < L ? b0 + block_b : L;
  place_block(keys, cnt, pos, b0, b1, nbins);
}

// `work` is the caller's copy of offsets: its rows are the counters.
__global__ void __launch_bounds__(32)
placement_global_kernel(const int32_t* __restrict__ keys,
                        int32_t* __restrict__ work, int32_t* __restrict__ pos,
                        long long L, int nbins, long long block_b) {
  const long long b0 = (long long)blockIdx.x * block_b;
  const long long b1 = b0 + block_b < L ? b0 + block_b : L;
  place_block(keys, work + (long long)blockIdx.x * nbins, pos, b0, b1, nbins);
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

// shared != 0: counters in shared memory, `offsets` only read; else
// `offsets` is a scratch copy whose rows the kernel advances.
extern "C" int placement_launch(const void* keys, void* offsets, void* pos,
                                long long L, int nbins, long long block_b,
                                int nblocks, int shared, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (shared) {
    const size_t smem = (size_t)nbins * sizeof(int);
    int rc = (int)cudaFuncSetAttribute(
        placement_shared_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (rc) return rc;
    placement_shared_kernel<<<nblocks, kThreads, smem, s>>>(
        (const int32_t*)keys, (const int32_t*)offsets, (int32_t*)pos, L,
        nbins, block_b);
    return (int)cudaGetLastError();
  }
  placement_global_kernel<<<nblocks, 32, 0, s>>>(
      (const int32_t*)keys, (int32_t*)offsets, (int32_t*)pos, L, nbins,
      block_b);
  return (int)cudaGetLastError();
}
