// Batched exhaustive nearest neighbour in one launch.
//
// Replaces: tpu_slam/ops/pallas/nn.py::nearest_neighbor_pallas.
//
// For every source point of every pair: the index and squared distance of
// the nearest valid target point of the same pair, invalid targets pushed
// out by 1e12, ties to the first index, (M, NaN) where a distance is NaN.
//
// What bounds it on the H100: N x M distance evaluations per pair, each
// two subtractions, a multiply, an fma, an add and a compare, against a
// few KB of inputs per pair. At the odometry's one pair of 360 x 360 it
// is latency (one source's scan of all targets is a serial chain of
// compares); at batches of hundreds of pairs it is bound by issue rate,
// not by bytes.
//
// Design (ops/cuda/nn.py::nn_geometry chooses the shape): grid (B, tiles),
// a block per tile of one pair's sources, a source per group of G lanes
// (G a power of two <= 32, doubled while B N G lanes do not fill the
// card). The block stages the pair's targets in shared memory, packed as
// float4 (x, y, penalty, 0) with the penalty already 0 or 1e12, so one
// load feeds a distance: all M at once up to 4,096 (64 KB), past that in
// chunks of 4,096 in index order, a barrier before and after each
// restage, the lane's minimum, its index and its NaN flag carried across
// them. Lane g scans targets g, g + G, g + 2G, ...
// (consecutive lanes on consecutive float4s, no bank conflict), keeps the
// first index of its minimum with a strict <, and the group merges
// (d2, index) lexicographically with warp shuffles: the smaller d2 wins,
// on equal d2 the smaller index. A lane starts at (+inf, g), so a lane
// with no target or none below +inf loses to lane 0's (+inf, 0), and the
// result is the first index of the least distance, index 0 and +inf when
// nothing beats +inf.
// NaN follows the reference kernel, whose min passes a NaN through and
// whose d2 <= min then holds nowhere: a source with a NaN distance to any
// target of its pair (a NaN coordinate on either side, valid or not)
// gets index M and d2 NaN (the quiet NaN 0x7fc00000). A lane flags a NaN
// it meets, and a flagged lane wins every merge.
// The arithmetic is the reference kernel's, rounded as written with the
// _rn intrinsics so that nvcc contracts nothing else:
//   d2 = (fma(dx, dx, dy * dy)) + penalty,  dx = sx - tx,
// and adding the staged 0 or 1e12 is the same bits as adding the
// conditional. The plain version (ops/matching.nearest_neighbor_direct)
// computes the same bits. The TPU kernel's 8-pair padding and transposed
// (2, M) target layout are VMEM tiling and are not carried over.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int MAX_THREADS = 256;
constexpr int MAX_LANES = 32;  // lanes a source: one warp
constexpr float BIG = 1e12f;
constexpr unsigned FULL = 0xffffffffu;
constexpr int QNAN = 0x7fc00000;  // the quiet NaN a NaN row gets

// Block (blockIdx.x = pair b, blockIdx.y = tile): `tile` = blockDim / G
// sources of pair b from blockIdx.y * tile on; thread t serves source
// t / G as lane t % G. The pair's targets are staged `mc` at a time (mc a
// multiple of 32 when there is more than one chunk), chunk after chunk in
// index order.
__global__ void __launch_bounds__(MAX_THREADS)
    nn_kernel(const float* __restrict__ src, const float* __restrict__ tgt,
              const uint8_t* __restrict__ tgt_valid,
              int64_t* __restrict__ idx_out, float* __restrict__ d2_out,
              int N, int M, int G, int mc) {
  extern __shared__ float4 tg[];
  const int64_t b = blockIdx.x;
  const float* t = tgt + b * 2 * (int64_t)M;
  const uint8_t* v = tgt_valid + b * (int64_t)M;
  const int g = threadIdx.x & (G - 1);
  const int i = blockIdx.y * (blockDim.x / G) + threadIdx.x / G;
  const int ic = min(i, N - 1);  // past N: a copy, never written
  const float sx = src[(b * N + ic) * 2];
  const float sy = src[(b * N + ic) * 2 + 1];
  float best = __int_as_float(0x7f800000);  // +inf
  int arg = g;
  bool nan = false;
  for (int k0 = 0; k0 < M; k0 += mc) {
    const int m = min(mc, M - k0);
    if (k0 > 0) __syncthreads();  // every lane is done with the last chunk
    for (int j = threadIdx.x; j < m; j += blockDim.x)
      tg[j] = make_float4(t[2 * (k0 + j)], t[2 * (k0 + j) + 1],
                          v[k0 + j] ? 0.f : BIG, 0.f);
    __syncthreads();
    // lane g's share, targets g, g + G, ...: mc is a multiple of G, so the
    // shares of the chunks make one stride and one strict < across them
#pragma unroll 4
    for (int j = g; j < m; j += G) {
      const float4 q = tg[j];
      const float dx = __fsub_rn(sx, q.x);
      const float dy = __fsub_rn(sy, q.y);
      const float d = __fadd_rn(__fmaf_rn(dx, dx, __fmul_rn(dy, dy)), q.z);
      nan |= d != d;
      if (d < best) {
        best = d;
        arg = k0 + j;
      }
    }
  }
  if (nan) {
    best = __int_as_float(QNAN);
    arg = M;
  }
  // the group's lanes are aligned within the warp (G divides 32), and
  // every thread of the block reaches the shuffles
  for (int o = G >> 1; o > 0; o >>= 1) {
    const float ob = __shfl_xor_sync(FULL, best, o);
    const int oa = __shfl_xor_sync(FULL, arg, o);
    if (!(best != best) &&
        (ob != ob || ob < best || (ob == best && oa < arg))) {
      best = ob;
      arg = oa;
    }
  }
  if (g == 0 && i < N) {
    idx_out[b * N + i] = arg;
    d2_out[b * N + i] = best;
  }
}

}  // namespace

// src (B, N, 2) f32, tgt (B, M, 2) f32, tgt_valid (B, M) bool (one byte),
// idx (B, N) int64, d2 (B, N) f32; all contiguous on one device. `lanes`
// (G), `threads` a block, `tiles` a pair, `smem` bytes and `mc` targets a
// staged chunk come from ops/cuda/nn.py::nn_geometry. Returns a
// cudaError_t (0 on success; non-zero when the geometry does not cover
// the sources or the chunks).
extern "C" int nn_launch(const void* src, const void* tgt,
                         const void* tgt_valid, void* idx, void* d2, int B,
                         int N, int M, int lanes, int threads, int tiles,
                         int smem, int mc, void* stream) {
  const int G = lanes;
  if (B < 1 || N < 1 || M < 1 || G < 1 || G > MAX_LANES || (G & (G - 1)) ||
      threads < 32 || threads > MAX_THREADS || threads % 32 ||
      tiles < 1 || tiles > 65535 || (int64_t)tiles * (threads / G) < N ||
      mc < 1 || (mc < M && mc % MAX_LANES) ||
      smem < mc * (int)sizeof(float4))
    return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        nn_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
  }
  nn_kernel<<<dim3(B, tiles), threads, smem, (cudaStream_t)stream>>>(
      (const float*)src, (const float*)tgt, (const uint8_t*)tgt_valid,
      (int64_t*)idx, (float*)d2, N, M, G, mc);
  return (int)cudaGetLastError();
}
