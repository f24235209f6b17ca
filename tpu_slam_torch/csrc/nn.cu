// Batched exhaustive nearest neighbour in one launch.
//
// Replaces: tpu_slam/ops/pallas/nn.py::nearest_neighbor_pallas.
//
// For every source point of every pair: the index and squared distance of
// the nearest valid target point of the same pair, invalid targets pushed
// out by 1e12, ties to the first index.
//
// What bounds it on the H100: N x M distance evaluations per pair, each
// two subtractions, a multiply, an fma, an add and a compare, against a
// few KB of inputs per pair. At the odometry's one pair of 360 x 360 it
// is one small block and the launch itself; at batches of hundreds of
// pairs it is bound by issue rate, not by bytes.
//
// Design: grid (B, ceil(N / 256)), 256 threads; a block stages its pair's
// M targets in shared memory (x and y as floats, valid as a byte: 36 KB
// at the 4,096-target cap), then each thread scans them all for its own
// source point. The arithmetic is the reference kernel's, rounded as
// written with the _rn intrinsics so that nvcc contracts nothing else:
//   d2 = (fma(dx, dx, dy * dy)) + (1 - valid) * 1e12,  dx = sx - tx,
// and a strict < keeps the first index of the minimum. The plain version
// (ops/matching.nearest_neighbor_direct) computes the same bits. The TPU
// kernel's 8-pair padding and transposed (2, M) target layout are VMEM
// tiling and are not carried over.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr float BIG = 1e12f;

__global__ void nn_kernel(const float* __restrict__ src,
                          const float* __restrict__ tgt,
                          const uint8_t* __restrict__ tgt_valid,
                          int64_t* __restrict__ idx_out,
                          float* __restrict__ d2_out, int N, int M) {
  extern __shared__ float sh[];
  float* tx = sh;
  float* ty = sh + M;
  uint8_t* tv = reinterpret_cast<uint8_t*>(sh + 2 * M);
  const int64_t b = blockIdx.x;
  const float* t = tgt + b * 2 * (int64_t)M;
  const uint8_t* v = tgt_valid + b * (int64_t)M;
  for (int j = threadIdx.x; j < M; j += blockDim.x) {
    tx[j] = t[2 * j];
    ty[j] = t[2 * j + 1];
    tv[j] = v[j];
  }
  __syncthreads();
  const int i = blockIdx.y * blockDim.x + threadIdx.x;
  if (i >= N) return;
  const float sx = src[(b * N + i) * 2];
  const float sy = src[(b * N + i) * 2 + 1];
  float best = __int_as_float(0x7f800000);  // +inf
  int arg = 0;
  for (int j = 0; j < M; ++j) {
    const float dx = __fsub_rn(sx, tx[j]);
    const float dy = __fsub_rn(sy, ty[j]);
    const float d = __fadd_rn(__fmaf_rn(dx, dx, __fmul_rn(dy, dy)),
                              tv[j] ? 0.f : BIG);
    if (d < best) {
      best = d;
      arg = j;
    }
  }
  idx_out[b * N + i] = arg;
  d2_out[b * N + i] = best;
}

}  // namespace

// src (B, N, 2) f32, tgt (B, M, 2) f32, tgt_valid (B, M) bool (one byte),
// idx (B, N) int64, d2 (B, N) f32; all contiguous on one device. Returns
// a cudaError_t (0 on success).
extern "C" int nn_launch(const void* src, const void* tgt,
                         const void* tgt_valid, void* idx, void* d2, int B,
                         int N, int M, void* stream) {
  const dim3 grid(B, (N + THREADS - 1) / THREADS);
  const size_t shmem = (size_t)M * (2 * sizeof(float) + 1);
  nn_kernel<<<grid, THREADS, shmem, (cudaStream_t)stream>>>(
      (const float*)src, (const float*)tgt, (const uint8_t*)tgt_valid,
      (int64_t*)idx, (float*)d2, N, M);
  return (int)cudaGetLastError();
}
