// Launching a kernel as one thread-block cluster, shared by the two LM
// kernels (cr_lm.cu, pcg_lm.cu). The library hash in _build.py covers this
// header.

#pragma once

#include <cuda_runtime.h>

namespace {

// Launch `kern` as one cluster of `blocks` blocks of `threads` threads with
// `smem` bytes of dynamic shared memory each. Returns a cudaError_t:
// non-zero when the card refuses the shared memory or cannot place the
// cluster (checked before the launch), or the launch fails.
template <class... Params, class... Args>
int launch_cluster(void (*kern)(Params...), int blocks, int threads, int smem,
                   cudaStream_t stream, Args... args) {
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = blocks;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int clusters = 0;
  e = cudaOccupancyMaxActiveClusters(&clusters, kern, &cfg);
  if (e != cudaSuccess) return (int)e;
  if (clusters < 1) return (int)cudaErrorLaunchOutOfResources;
  e = cudaLaunchKernelEx(&cfg, kern, args...);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

}  // namespace
