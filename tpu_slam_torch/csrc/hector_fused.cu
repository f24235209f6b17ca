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
// under a microsecond. But the 14 steps depend on each other: each step's
// taps need the pose that the previous step's block-wide sum of 9 terms
// and 3x3 solve gave. So the time is 14 x the latency of one step: the
// rotation, the tap loads from L2, the sums and one barrier.
//
// Design (ops/cuda/hector_fused.py::hector_geometry picks the shape): one
// thread block per match, T threads with K beams each in registers (beam
// k*T + t on thread t). A thread loads its beams' points and valid flags
// once per match and scales them by 1/resolution once per level, so a
// step's only memory round trip is its 4 tap loads a beam, all issued
// before any is used, read straight from the probability grid (the default
// pyramid's 1024^2 + 512^2 + 256^2 floats, 5.25 MB, stay in the 50 MB L2
// across steps and scans). One barrier a step: the 9 sums h00..h22, b0..b2
// are reduced with warp shuffles, each warp's partial goes to a shared
// buffer that alternates between steps (so no barrier trails the read),
// and then each warp adds the partials in warp order (lane q the q-th sum)
// and shuffles the totals to all its lanes, and every thread solves the
// same 3x3 system, so all threads carry the same pose without a block-wide
// broadcast. A scan of more beams than the largest instance holds (T = 512,
// K = 8) is taken in chunks: beam (c*K + k)*T + t, the first chunk in
// registers and the others read again at each step. Off-map and invalid
// beams add exactly zero. The TPU kernel's
// one-hot row matmuls, masked lane reductions and pose-centred VMEM window
// exist only because of the TPU and are not carried over.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int MAX_LEVELS = 8;
constexpr int MAX_THREADS = 1024;
constexpr int MAX_BEAMS_PER_THREAD = 8;  // template instances
constexpr int NSUM = 9;  // h00 h01 h02 h11 h12 h22 b0 b1 b2
constexpr unsigned FULL = 0xffffffffu;

struct Levels {
  const float* grid[MAX_LEVELS];  // (size_y, size_x) occupancy probability
  int sx[MAX_LEVELS];
  int sy[MAX_LEVELS];
  float res[MAX_LEVELS];
  float ox[MAX_LEVELS];
  float oy[MAX_LEVELS];
};

// The most threads a block of the K-beams instance takes (its launch
// bounds): up to 4 beams a thread the whole block, above that half.
__host__ __device__ constexpr int max_threads(int K) {
  return K <= 4 ? MAX_THREADS : MAX_THREADS / 2;
}

// Chunk ch of the thread's beams, (ch*K + k)*T + t, scaled by 1/res:
// the points (0 where invalid or past N) and a bit a valid beam.
template <int K>
__device__ __forceinline__ unsigned load_beams(
    const float* __restrict__ pts, const unsigned char* __restrict__ valid,
    int N, int ch, float res, float (&px)[K], float (&py)[K]) {
  unsigned use = 0;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int i = (ch * K + k) * blockDim.x + threadIdx.x;
    px[k] = py[k] = 0.f;
    if (i < N && valid[i]) {
      px[k] = pts[2 * i] / res;
      py[k] = pts[2 * i + 1] / res;
      use |= 1u << k;
    }
  }
  return use;
}

// Adds K beams (map-cell units, laser frame) at the step's pose (s, c,
// pmx, pmy) to the thread's 9 sums v. All 4K tap loads come first,
// unconditionally (an off-map or invalid beam reads the clamped cell 0
// and is masked after), so that they are in flight together: one L2
// round trip a step.
template <int K>
__device__ __forceinline__ void add_beams(const float* __restrict__ g,
                                          int sx, int sy, float s, float c,
                                          float pmx, float pmy,
                                          const float (&px)[K],
                                          const float (&py)[K], unsigned use,
                                          float (&v)[NSUM]) {
  float fx[K], fy[K], p00[K], p10[K], p01[K], p11[K];
  bool on[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    // cell-centre query; the bounds test is on the float coords
    const float xq = (c * px[k] - s * py[k] + pmx) - 0.5f;
    const float yq = (s * px[k] + c * py[k] + pmy) - 0.5f;
    on[k] = ((use >> k) & 1u) && xq >= 0.f && yq >= 0.f &&
            xq < (float)(sx - 1) && yq < (float)(sy - 1);
    const int x0 = on[k] ? min((int)floorf(xq), sx - 2) : 0;
    const int y0 = on[k] ? min((int)floorf(yq), sy - 2) : 0;
    fx[k] = xq - (float)x0;
    fy[k] = yq - (float)y0;
    const float* row = g + (size_t)y0 * sx + x0;
    p00[k] = row[0];
    p10[k] = row[1];
    p01[k] = row[sx];
    p11[k] = row[sx + 1];
  }
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const float xi = 1.f - fx[k], yi = 1.f - fy[k];
    const float val = (p00[k] * xi + p10[k] * fx[k]) * yi +
                      (p01[k] * xi + p11[k] * fx[k]) * fy[k];
    const float gx = -((p00[k] - p10[k]) * yi + (p01[k] - p11[k]) * fy[k]);
    const float gy = -((p00[k] - p01[k]) * xi + (p10[k] - p11[k]) * fx[k]);
    // off the map or invalid: every term exactly zero
    const float dx = on[k] ? gx : 0.f, dy = on[k] ? gy : 0.f;
    const float rot = on[k] ? (-s * px[k] - c * py[k]) * gx +
                                  (c * px[k] - s * py[k]) * gy
                            : 0.f;
    const float r = on[k] ? 1.f - val : 0.f;
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
}

template <int K>
__global__ void __launch_bounds__(K <= 4 ? MAX_THREADS : MAX_THREADS / 2)
    hector_fused_kernel(Levels lv, int L, const float* __restrict__ pts,
                        const unsigned char* __restrict__ valid,
                        const float* __restrict__ pose_in,
                        float* __restrict__ out, int N, int iters_fine,
                        int iters_coarse, float max_rot_step) {
  __shared__ float part[2][(MAX_THREADS / 32) * NSUM];
  const int T = blockDim.x, t = threadIdx.x, nw = T >> 5;
  const int chunks = (N + K * T - 1) / (K * T);

  // the thread's first chunk of beams, once per match (unscaled)
  float rx[K], ry[K];
  const unsigned use = load_beams<K>(pts, valid, N, 0, 1.f, rx, ry);

  float pwx = pose_in[0], pwy = pose_in[1], pth = pose_in[2];
  float tot[NSUM] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  int buf = 0;

  for (int lvl = L - 1; lvl >= 0; --lvl) {
    const float* __restrict__ g = lv.grid[lvl];
    const int sx = lv.sx[lvl], sy = lv.sy[lvl];
    const float res = lv.res[lvl], ox = lv.ox[lvl], oy = lv.oy[lvl];
    const int steps = (lvl == 0 ? iters_fine : iters_coarse) + 1;
    float pmx = (pwx - ox) / res;
    float pmy = (pwy - oy) / res;
    float th = pth;
    float px[K], py[K];
#pragma unroll
    for (int k = 0; k < K; ++k) {
      px[k] = rx[k] / res;
      py[k] = ry[k] / res;
    }

    for (int it = 0; it < steps; ++it) {
      float s, c;
      sincosf(th, &s, &c);
      float v[NSUM] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
      add_beams<K>(g, sx, sy, s, c, pmx, pmy, px, py, use, v);
      for (int ch = 1; ch < chunks; ++ch) {
        float qx[K], qy[K];
        const unsigned u = load_beams<K>(pts, valid, N, ch, res, qx, qy);
        add_beams<K>(g, sx, sy, s, c, pmx, pmy, qx, qy, u, v);
      }
#pragma unroll
      for (int q = 0; q < NSUM; ++q)
        for (int o = 16; o > 0; o >>= 1) v[q] += __shfl_xor_sync(FULL, v[q], o);
      float* p = part[buf];
      if ((t & 31) == 0) {
#pragma unroll
        for (int q = 0; q < NSUM; ++q) p[(t >> 5) * NSUM + q] = v[q];
      }
      __syncthreads();  // the one barrier of the step
      {  // lane q < 9 adds sum q over the warps in order, then broadcasts
        const int q = t & 31;
        float sum = 0.f;
        if (q < NSUM) {
          sum = p[q];
#pragma unroll 4
          for (int w = 1; w < nw; ++w) sum += p[w * NSUM + q];
        }
#pragma unroll
        for (int k = 0; k < NSUM; ++k) tot[k] = __shfl_sync(FULL, sum, k);
      }
      buf ^= 1;

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

  if (t == 0) {
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
// are device pointers. `threads` and `bpt` beams a thread come from
// ops/cuda/hector_fused.py::hector_geometry; beams past threads x bpt are
// taken in chunks. Returns a cudaError_t (0 on success; non-zero when the
// geometry is not one of the instances').
extern "C" int hector_fused_launch(const void* const* grids, const int* sizes,
                                   const float* geo, int L, const void* pts,
                                   const void* valid, const void* pose_in,
                                   void* out, int N, int iters_fine,
                                   int iters_coarse, float max_rot_step,
                                   int threads, int bpt, void* stream) {
  if (L < 1 || L > MAX_LEVELS || N < 1 || threads < 32 || threads % 32 ||
      bpt < 1 || bpt > MAX_BEAMS_PER_THREAD || threads > max_threads(bpt))
    return (int)cudaErrorInvalidValue;
  Levels lv;
  for (int l = 0; l < L; ++l) {
    lv.grid[l] = (const float*)grids[l];
    lv.sx[l] = sizes[2 * l];
    lv.sy[l] = sizes[2 * l + 1];
    lv.res[l] = geo[3 * l];
    lv.ox[l] = geo[3 * l + 1];
    lv.oy[l] = geo[3 * l + 2];
  }
  const cudaStream_t st = (cudaStream_t)stream;
#define HECTOR_CASE(K)                                                  \
  case K:                                                               \
    hector_fused_kernel<K><<<1, threads, 0, st>>>(                      \
        lv, L, (const float*)pts, (const unsigned char*)valid,          \
        (const float*)pose_in, (float*)out, N, iters_fine, iters_coarse, \
        max_rot_step);                                                  \
    break;
  switch (bpt) {
    HECTOR_CASE(1) HECTOR_CASE(2) HECTOR_CASE(3) HECTOR_CASE(4)
    HECTOR_CASE(5) HECTOR_CASE(6) HECTOR_CASE(7) HECTOR_CASE(8)
  }
#undef HECTOR_CASE
  return (int)cudaGetLastError();
}
