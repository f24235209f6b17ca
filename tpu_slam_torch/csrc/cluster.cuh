// Launching a kernel as one thread-block cluster, shared by the LM kernels
// (cr_lm.cu, cr_stream.cu, pcg_lm.cu). The library hash in _build.py
// covers this header.

#pragma once

#include <cuda_runtime.h>

namespace {

// A cluster launch's configuration; filled in place by cluster_config, so
// that cfg.attrs points at this object's own attribute.
struct ClusterLaunch {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
};

// Configure `kern` for one cluster of `blocks` blocks of `threads` threads
// with `smem` bytes of dynamic shared memory each. Returns a cudaError_t:
// non-zero when the card refuses the shared memory or cannot place the
// cluster.
template <class... Params>
int cluster_config(void (*kern)(Params...), int blocks, int threads, int smem,
                   cudaStream_t stream, ClusterLaunch& l) {
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  l.cfg = cudaLaunchConfig_t{};
  l.cfg.gridDim = dim3(blocks);
  l.cfg.blockDim = dim3(threads);
  l.cfg.dynamicSmemBytes = smem;
  l.cfg.stream = stream;
  l.attr[0].id = cudaLaunchAttributeClusterDimension;
  l.attr[0].val.clusterDim.x = blocks;
  l.attr[0].val.clusterDim.y = 1;
  l.attr[0].val.clusterDim.z = 1;
  l.cfg.attrs = l.attr;
  l.cfg.numAttrs = 1;
  int clusters = 0;
  e = cudaOccupancyMaxActiveClusters(&clusters, kern, &l.cfg);
  if (e != cudaSuccess) return (int)e;
  if (clusters < 1) return (int)cudaErrorLaunchOutOfResources;
  return 0;
}

// Launch `kern` as one cluster (see cluster_config). Returns a
// cudaError_t: non-zero when the card refuses the shared memory or cannot
// place the cluster (checked before the launch), or the launch fails.
template <class... Params, class... Args>
int launch_cluster(void (*kern)(Params...), int blocks, int threads, int smem,
                   cudaStream_t stream, Args... args) {
  ClusterLaunch l;
  const int err = cluster_config(kern, blocks, threads, smem, stream, l);
  if (err != 0) return err;
  const cudaError_t e = cudaLaunchKernelEx(&l.cfg, kern, args...);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

}  // namespace
