// The per-kernel resource query each library exports for the resource
// report (repro_torch/sparse/analysis/vmem.py): for every kernel instance
// a launch path takes, what cudaFuncGetAttributes and the occupancy
// calculator give on the card the library runs on.
//
// A library lists its instances in a table of KernelResource (name,
// kernel, threads a block, dynamic shared bytes of the launch the report
// describes) and exports it with REPRO_RESOURCE_TABLE:
//   resource_count()        the number of instances;
//   resource_name(i)        instance i's name;
//   resource_query(i, out)  fills out[0..7] and returns a cudaError_t:
//     threads a block, registers a thread, local (spill) bytes a thread,
//     static shared bytes, dynamic shared bytes, the kernel's largest
//     block, resident blocks an SM at that launch, and the card's
//     opt-in shared bytes a block.
#pragma once
#include <cuda_runtime.h>

struct KernelResource {
  const char* name;
  const void* fn;
  int threads;
  long long dyn_smem;
};

inline int query_resource(const KernelResource& k, long long* out) {
  cudaFuncAttributes a;
  int rc = (int)cudaFuncGetAttributes(&a, k.fn);
  if (rc) return rc;
  // past what the kernel may take now (by default 48 KB less its static
  // bytes): opt in, as its launches do, whether or not one ran yet; a
  // larger size a launch set stays
  if (k.dyn_smem > a.maxDynamicSharedSizeBytes) {
    rc = (int)cudaFuncSetAttribute(
        k.fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)k.dyn_smem);
    if (rc) return rc;
  }
  int blocks = 0;
  rc = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &blocks, k.fn, k.threads, (size_t)k.dyn_smem);
  if (rc) return rc;
  int dev = 0, optin = 0;
  rc = (int)cudaGetDevice(&dev);
  if (rc) return rc;
  rc = (int)cudaDeviceGetAttribute(
      &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (rc) return rc;
  out[0] = k.threads;
  out[1] = a.numRegs;
  out[2] = (long long)a.localSizeBytes;
  out[3] = (long long)a.sharedSizeBytes;
  out[4] = k.dyn_smem;
  out[5] = a.maxThreadsPerBlock;
  out[6] = blocks;
  out[7] = optin;
  return 0;
}

#define REPRO_RESOURCE_TABLE(table)                                   \
  extern "C" int resource_count(void) {                               \
    return (int)(sizeof(table) / sizeof(table[0]));                   \
  }                                                                   \
  extern "C" const char* resource_name(int i) { return table[i].name; } \
  extern "C" int resource_query(int i, long long* out) {              \
    return query_resource(table[i], out);                             \
  }
