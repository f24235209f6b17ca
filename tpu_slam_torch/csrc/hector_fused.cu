// The whole coarse-to-fine Hector Gauss-Newton scan-to-map match in one
// launch: every pyramid level, every GN step, the 3x3 solves and the
// world <-> map conversions between levels.
//
// Replaces: tpu_slam/ops/pallas/hector_fused.py::hector_match_fused
// (Pallas kernel _make_kernel), full-grid mode. Plain PyTorch version:
// tpu_slam_torch/ops/hector.py::match_multires.
//
// What bounds it on the H100: latency. One match reads a few thousand
// grid cells (14 GN steps x 360 beams x 4 bilinear taps, most of them in
// L2) and does ~0.3 MFLOP, which the card could move and compute in well
// under a microsecond. But the 14 steps depend on each other, and each
// ends in a block-wide reduction of 9 sums and a 3x3 solve before the
// next step may rotate its points.
//
// Design: one thread block per match, one thread per beam (threads loop
// over beams when N exceeds the block). The level loop and all GN steps
// run inside the kernel, so each dependency is a __syncthreads() and not a
// kernel launch. Each thread reads its 4 bilinear taps straight from the
// probability grid in global memory through the read-only cache: the
// three grids of the default pyramid (1024^2 + 512^2 + 256^2 floats,
// 5.25 MB) stay in the 50 MB L2 across steps and scans. The 9 sums
// h00..h22, b0..b2 are reduced with warp shuffles and then across warps in
// shared memory in a fixed order, and every thread then solves the same
// 3x3 system from the same totals, so all threads carry the same pose
// without a broadcast. The TPU kernel's one-hot row matmuls, masked lane
// reductions and pose-centred VMEM window exist only because of the TPU
// and are not carried over.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int MAX_LEVELS = 8;
constexpr int MAX_THREADS = 1024;
constexpr int NSUM = 9;  // h00 h01 h02 h11 h12 h22 b0 b1 b2

struct Levels {
  const float* grid[MAX_LEVELS];  // (size_y, size_x) occupancy probability
  int sx[MAX_LEVELS];
  int sy[MAX_LEVELS];
  float res[MAX_LEVELS];
  float ox[MAX_LEVELS];
  float oy[MAX_LEVELS];
};

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  return v;
}

// Block-wide sums of the NSUM values in v, in a fixed order; every thread
// gets the totals in tot.
__device__ void block_sums(float (&v)[NSUM], float (&tot)[NSUM],
                           float (*red)[MAX_THREADS / 32], float* out) {
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  const int nw = (blockDim.x + 31) >> 5;
#pragma unroll
  for (int q = 0; q < NSUM; ++q) {
    const float s = warp_sum(v[q]);
    if (lane == 0) red[q][wid] = s;
  }
  __syncthreads();
  if (threadIdx.x < NSUM) {
    float s = 0.f;
    for (int w = 0; w < nw; ++w) s += red[threadIdx.x][w];
    out[threadIdx.x] = s;
  }
  __syncthreads();
#pragma unroll
  for (int q = 0; q < NSUM; ++q) tot[q] = out[q];
  __syncthreads();  // red and out are reused by the next step
}

__global__ void hector_fused_kernel(Levels lv, int L,
                                    const float* __restrict__ pts,
                                    const unsigned char* __restrict__ valid,
                                    const float* __restrict__ pose_in,
                                    float* __restrict__ out, int N,
                                    int iters_fine, int iters_coarse,
                                    float max_rot_step) {
  __shared__ float red[NSUM][MAX_THREADS / 32];
  __shared__ float sums[NSUM];

  float pwx = pose_in[0], pwy = pose_in[1], pth = pose_in[2];
  float tot[NSUM] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};

  for (int lvl = L - 1; lvl >= 0; --lvl) {
    const float* __restrict__ g = lv.grid[lvl];
    const int sx = lv.sx[lvl], sy = lv.sy[lvl];
    const float res = lv.res[lvl], ox = lv.ox[lvl], oy = lv.oy[lvl];
    const int steps = (lvl == 0 ? iters_fine : iters_coarse) + 1;
    float pmx = (pwx - ox) / res;
    float pmy = (pwy - oy) / res;
    float th = pth;

    for (int it = 0; it < steps; ++it) {
      const float c = cosf(th), s = sinf(th);
      float v[NSUM] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
      for (int i = threadIdx.x; i < N; i += blockDim.x) {
        if (!valid[i]) continue;
        const float px = pts[2 * i] / res;
        const float py = pts[2 * i + 1] / res;
        // cell-centre query; the bounds test is on the float coords
        const float xq = (c * px - s * py + pmx) - 0.5f;
        const float yq = (s * px + c * py + pmy) - 0.5f;
        if (!(xq >= 0.f && yq >= 0.f && xq < (float)(sx - 1) &&
              yq < (float)(sy - 1)))
          continue;  // off the map: adds exactly zero
        const int x0 = min((int)floorf(xq), sx - 2);
        const int y0 = min((int)floorf(yq), sy - 2);
        const float fx = xq - (float)x0, fy = yq - (float)y0;
        const float* row = g + (size_t)y0 * sx + x0;
        const float p00 = __ldg(row), p10 = __ldg(row + 1);
        const float p01 = __ldg(row + sx), p11 = __ldg(row + sx + 1);
        const float xi = 1.f - fx, yi = 1.f - fy;
        const float val = (p00 * xi + p10 * fx) * yi + (p01 * xi + p11 * fx) * fy;
        const float dx = -((p00 - p10) * yi + (p01 - p11) * fy);
        const float dy = -((p00 - p01) * xi + (p10 - p11) * fx);
        const float rot = (-s * px - c * py) * dx + (c * px - s * py) * dy;
        const float r = 1.f - val;
        v[0] += dx * dx;
        v[1] += dx * dy;
        v[2] += dx * rot;
        v[3] += dy * dy;
        v[4] += dy * rot;
        v[5] += rot * rot;
        v[6] += dx * r;
        v[7] += dy * r;
        v[8] += rot * r;
      }
      block_sums(v, tot, red, sums);

      // (H + 1e-9 I) d = b by cofactors, as the TPU kernel's _solve3
      const float h00 = tot[0] + 1e-9f, h01 = tot[1], h02 = tot[2];
      const float h11 = tot[3] + 1e-9f, h12 = tot[4], h22 = tot[5] + 1e-9f;
      const float b0 = tot[6], b1 = tot[7], b2 = tot[8];
      const float c00 = h11 * h22 - h12 * h12;
      const float c01 = h02 * h12 - h01 * h22;
      const float c02 = h01 * h12 - h02 * h11;
      const float det = h00 * c00 + h01 * c01 + h02 * c02;
      if (det != 0.f && tot[0] != 0.f && tot[3] != 0.f) {
        const float c11 = h00 * h22 - h02 * h02;
        const float c12 = h01 * h02 - h00 * h12;
        const float c22 = h00 * h11 - h01 * h01;
        const float inv = 1.f / det;
        const float d0 = (c00 * b0 + c01 * b1 + c02 * b2) * inv;
        const float d1 = (c01 * b0 + c11 * b1 + c12 * b2) * inv;
        float d2 = (c02 * b0 + c12 * b1 + c22 * b2) * inv;
        if (isfinite(d0) && isfinite(d1) && isfinite(d2)) {
          d2 = fminf(fmaxf(d2, -max_rot_step), max_rot_step);
          pmx += d0;
          pmy += d1;
          th += d2;
        }
      }
    }
    pth = atan2f(sinf(th), cosf(th));
    pwx = pmx * res + ox;
    pwy = pmy * res + oy;
  }

  if (threadIdx.x == 0) {
    out[0] = pwx;
    out[1] = pwy;
    out[2] = pth;
    // H of the finest level's last step, without the ridge
    const int map[9] = {0, 1, 2, 1, 3, 4, 2, 4, 5};
    for (int q = 0; q < 9; ++q) out[3 + q] = tot[map[q]];
  }
}

}  // namespace

// grids, sizes (2L: size_x, size_y per level) and geo (3L: resolution,
// origin_x, origin_y per level) are HOST arrays; pts (N, 2) f32, valid
// (N,) bool, pose_in (3,) f32 and out (12,) f32 (pose, then H row-major)
// are device pointers.
extern "C" int hector_fused_launch(const void* const* grids, const int* sizes,
                                   const float* geo, int L, const void* pts,
                                   const void* valid, const void* pose_in,
                                   void* out, int N, int iters_fine,
                                   int iters_coarse, float max_rot_step,
                                   void* stream) {
  if (L < 1 || L > MAX_LEVELS || N < 1) return (int)cudaErrorInvalidValue;
  Levels lv;
  for (int l = 0; l < L; ++l) {
    lv.grid[l] = (const float*)grids[l];
    lv.sx[l] = sizes[2 * l];
    lv.sy[l] = sizes[2 * l + 1];
    lv.res[l] = geo[3 * l];
    lv.ox[l] = geo[3 * l + 1];
    lv.oy[l] = geo[3 * l + 2];
  }
  int threads = ((N + 31) / 32) * 32;
  if (threads > MAX_THREADS) threads = MAX_THREADS;
  hector_fused_kernel<<<1, threads, 0, (cudaStream_t)stream>>>(
      lv, L, (const float*)pts, (const unsigned char*)valid,
      (const float*)pose_in, (float*)out, N, iters_fine, iters_coarse,
      max_rot_step);
  return (int)cudaGetLastError();
}
