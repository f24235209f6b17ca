// Batched PL-ICP, the whole match loop in one launch.
//
// Replaces: tpu_slam/ops/pallas/plicp_fused.py::plicp_match_fused (both
// Pallas variants, _make_kernel and _make_kernel_bcast).
//
// What bounds it on the H100: the exhaustive nearest-neighbour search,
// N x M distance evaluations per pair and round (360 x 360 x 10 rounds at
// mission shapes), plus two block-wide sorts per round for the trimming
// quantiles. The data of one pair (a few KB) fits shared memory, so device
// memory traffic is negligible; the kernel is bound by issue rate and by
// block-wide synchronisation, not by bytes.
//
// Design: one thread block per scan pair, one thread per source beam. The
// pair's target beams sit in shared memory and every thread scans them
// directly (direct differences, no |a|^2+|b|^2-2ab expansion, so no
// cancellation and no centring). Ties go to the first index (strict <).
// The two trimming quantiles are exact: a bitonic sort of the masked |err|
// in shared memory, then the element at floor(q (cnt - 1)). The 6 + 3
// normal-equation sums are warp-shuffle block reductions in a fixed order;
// thread 0 solves the 3x3 system in closed form. All rounds run inside
// the launch and each pair stops at its own epsilons. The TPU kernel's
// split-bf16 passes, one-hot gather matmuls, 128-padding and 8/16-pair
// blocking are MXU workarounds and are not carried over.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float BIG = 1e12f;
constexpr int MAXV = 11;  // values per block reduction

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  return v;
}

// Sum NV per-thread values over the block; every thread gets the totals.
// blockDim.x is a multiple of 32. The order of summation is fixed.
template <int NV>
__device__ void block_sum(float (&v)[NV], float* red, float* out) {
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
#pragma unroll
  for (int q = 0; q < NV; ++q) v[q] = warp_sum(v[q]);
  if (lane == 0) {
#pragma unroll
    for (int q = 0; q < NV; ++q) red[wid * MAXV + q] = v[q];
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int q = 0; q < NV; ++q) {
      float s = 0.f;
      for (int w = 0; w < nw; ++w) s += red[w * MAXV + q];
      out[q] = s;
    }
  }
  __syncthreads();
#pragma unroll
  for (int q = 0; q < NV; ++q) v[q] = out[q];
  __syncthreads();  // out[] is reused by the next reduction
}

// Closed-form symmetric 3x3 solve (cofactors), determinant guard 1e-20.
__device__ void solve3(float h00, float h01, float h02, float h11, float h12,
                       float h22, float b0, float b1, float b2, float* d) {
  const float c00 = h11 * h22 - h12 * h12;
  const float c01 = h02 * h12 - h01 * h22;
  const float c02 = h01 * h12 - h02 * h11;
  const float det = h00 * c00 + h01 * c01 + h02 * c02;
  if (!(fabsf(det) > 1e-20f)) {
    d[0] = d[1] = d[2] = 0.f;
    return;
  }
  const float c11 = h00 * h22 - h02 * h02;
  const float c12 = h02 * h01 - h00 * h12;
  const float c22 = h00 * h11 - h01 * h01;
  d[0] = (c00 * b0 + c01 * b1 + c02 * b2) / det;
  d[1] = (c01 * b0 + c11 * b1 + c12 * b2) / det;
  d[2] = (c02 * b0 + c12 * b1 + c22 * b2) / det;
}

__global__ void plicp_fused_kernel(
    const float* __restrict__ src, const uint8_t* __restrict__ src_valid,
    const float* __restrict__ tgt, const uint8_t* __restrict__ tgt_valid,
    const float* __restrict__ init, float* __restrict__ pose_out,
    float* __restrict__ stats_out, float* __restrict__ h_out, int N, int M,
    int P2, int rounds, float max_d2, float eps_xy, float eps_th,
    float q_perc, float q_adap, float adap_mult) {
  extern __shared__ float smem[];
  float* tx = smem;
  float* ty = tx + M;
  float* tv = ty + M;
  float* srt = tv + M;  // P2 sort keys
  __shared__ float red[32 * MAXV];
  __shared__ float out[MAXV];
  __shared__ float st[16];  // thread 0 -> block broadcast

  const int b = blockIdx.x;
  const int i = threadIdx.x;
  const size_t tb = (size_t)b * M;
  // invalid or non-finite coordinates are zeroed; validity is kept as given
  for (int j = i; j < M; j += blockDim.x) {
    const bool v = tgt_valid[tb + j] != 0;
    const float x = tgt[2 * (tb + j)], y = tgt[2 * (tb + j) + 1];
    tx[j] = (v && isfinite(x)) ? x : 0.f;
    ty[j] = (v && isfinite(y)) ? y : 0.f;
    tv[j] = v ? 1.f : 0.f;
  }
  const bool act = i < N;
  bool sv = false;
  float sx = 0.f, sy = 0.f;
  if (act) {
    const size_t sb = (size_t)b * N + i;
    sv = src_valid[sb] != 0;
    const float x = src[2 * sb], y = src[2 * sb + 1];
    sx = (sv && isfinite(x)) ? x : 0.f;
    sy = (sv && isfinite(y)) ? y : 0.f;
  }
  float px = init[3 * b], py = init[3 * b + 1], pth = init[3 * b + 2];
  float err_o = 0.f, ninl_o = 0.f;
  float h_o[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  bool conv = false;
  __syncthreads();

  for (int rnd = 0; rnd < rounds && !conv; ++rnd) {
    // --- correspondences at the current pose
    float c = cosf(pth), s = sinf(pth);
    const float wx = c * sx - s * sy + px;
    const float wy = s * sx + c * sy + py;
    int j1 = 0;
    float best = BIG;
    for (int j = 0; j < M; ++j) {
      const float dx = wx - tx[j], dy = wy - ty[j];
      const float d = tv[j] > 0.f ? dx * dx + dy * dy : BIG;
      if (d < best || j == 0) {
        best = d;
        j1 = j;
      }
    }
    const float q1x = tx[j1], q1y = ty[j1];
    const int lo = max(j1 - 1, 0), hi = min(j1 + 1, M - 1);
    float dlo = BIG, dhi = BIG;
    if (tv[lo] > 0.f && lo != j1) {
      const float dx = wx - tx[lo], dy = wy - ty[lo];
      dlo = dx * dx + dy * dy;
    }
    if (tv[hi] > 0.f && hi != j1) {
      const float dx = wx - tx[hi], dy = wy - ty[hi];
      dhi = dx * dx + dy * dy;
    }
    const int j2 = dlo <= dhi ? lo : hi;
    const float tgx = tx[j2] - q1x, tgy = ty[j2] - q1y;
    const float tlen = sqrtf(tgx * tgx + tgy * tgy);
    const bool gate = act && sv && best < max_d2 && tv[j1] > 0.f &&
                      tlen > 1e-9f && tv[j2] > 0.f;
    const float tl = fmaxf(tlen, 1e-9f);
    const float nx = -(tgy / tl), ny = tgx / tl;
    const float resid = nx * (wx - q1x) + ny * (wy - q1y);
    const float err = fabsf(resid);

    // --- trimming: exact masked quantiles from a bitonic sort
    for (int t = i; t < P2; t += blockDim.x) srt[t] = (t == i && gate) ? err : BIG;
    float cnt[1] = {gate ? 1.f : 0.f};
    block_sum<1>(cnt, red, out);  // also orders the srt writes
    for (int k = 2; k <= P2; k <<= 1) {
      for (int jj = k >> 1; jj > 0; jj >>= 1) {
        for (int t = i; t < P2; t += blockDim.x) {
          const int ixj = t ^ jj;
          if (ixj > t) {
            const float a = srt[t], bb = srt[ixj];
            if ((a > bb) == ((t & k) == 0)) {
              srt[t] = bb;
              srt[ixj] = a;
            }
          }
        }
        __syncthreads();
      }
    }
    const float cnt1 = fmaxf(cnt[0] - 1.f, 0.f);
    const int pp = min(max((int)floorf(q_perc * cnt1), 0), N - 1);
    const int pa = min(max((int)floorf(q_adap * cnt1), 0), N - 1);
    const float thr = fminf(srt[pp], fmaxf(adap_mult * srt[pa], 1e-6f));
    const float w = (gate && err <= thr + 1e-12f) ? 1.f : 0.f;

    // --- first Gauss-Newton step on the frozen correspondences
    float jth = nx * (-(wy - py)) + ny * (wx - px);
    float v1[MAXV] = {w * nx * nx, w * nx * ny, w * nx * jth, w * ny * ny,
                      w * ny * jth, w * jth * jth, -(w * nx * resid),
                      -(w * ny * resid), -(w * jth * resid), w, w * err};
    block_sum<MAXV>(v1, red, out);
    if (i == 0) {
      float d[3];
      solve3(v1[0] + 1e-9f, v1[1], v1[2], v1[3] + 1e-9f, v1[4], v1[5] + 1e-9f,
             v1[6], v1[7], v1[8], d);
      const bool ok = v1[9] >= 3.f && isfinite(d[0]) && isfinite(d[1]) &&
                      isfinite(d[2]);
      for (int q = 0; q < 3; ++q) st[q] = ok ? d[q] : 0.f;
    }
    __syncthreads();
    const float d0 = st[0], d1 = st[1], d2 = st[2];
    const float px1 = px + d0, py1 = py + d1;
    const float pt1 = atan2f(sinf(pth + d2), cosf(pth + d2));
    __syncthreads();

    // --- second step from the updated pose, same correspondences
    c = cosf(pt1);
    s = sinf(pt1);
    const float w1x = c * sx - s * sy + px1;
    const float w1y = s * sx + c * sy + py1;
    const float r1 = nx * (w1x - q1x) + ny * (w1y - q1y);
    jth = nx * (-(w1y - py1)) + ny * (w1x - px1);
    float v2[9] = {w * nx * nx, w * nx * ny, w * nx * jth, w * ny * ny,
                   w * ny * jth, w * jth * jth, -(w * nx * r1),
                   -(w * ny * r1), -(w * jth * r1)};
    block_sum<9>(v2, red, out);
    for (int q = 0; q < 6; ++q) v2[q] += (q == 0 || q == 3 || q == 5) ? 1e-9f : 0.f;
    if (i == 0) {
      float d[3];
      solve3(v2[0], v2[1], v2[2], v2[3], v2[4], v2[5], v2[6], v2[7], v2[8], d);
      const bool ok = v1[9] >= 3.f && isfinite(d[0]) && isfinite(d[1]) &&
                      isfinite(d[2]);
      for (int q = 0; q < 3; ++q) st[q] = ok ? d[q] : 0.f;
    }
    __syncthreads();
    const float e0 = st[0], e1 = st[1], e2 = st[2];
    __syncthreads();
    px = px1 + e0;
    py = py1 + e1;
    pth = atan2f(sinf(pt1 + e2), cosf(pt1 + e2));
    err_o = v1[10] / fmaxf(v1[9], 1.f);
    ninl_o = v1[9];
    for (int q = 0; q < 6; ++q) h_o[q] = v2[q];
    conv = fabsf(d0 + e0) < eps_xy && fabsf(d1 + e1) < eps_xy &&
           fabsf(d2 + e2) < eps_th;
  }

  if (i == 0) {
    pose_out[3 * b] = px;
    pose_out[3 * b + 1] = py;
    pose_out[3 * b + 2] = pth;
    stats_out[4 * b] = err_o;
    stats_out[4 * b + 1] = ninl_o;
    stats_out[4 * b + 2] = conv ? 1.f : 0.f;
    stats_out[4 * b + 3] = 0.f;
    float* h = h_out + 9 * (size_t)b;
    h[0] = h_o[0]; h[1] = h_o[1]; h[2] = h_o[2];
    h[3] = h_o[1]; h[4] = h_o[3]; h[5] = h_o[4];
    h[6] = h_o[2]; h[7] = h_o[4]; h[8] = h_o[5];
  }
}

}  // namespace

extern "C" int plicp_fused_launch(
    const void* src, const void* src_valid, const void* tgt,
    const void* tgt_valid, const void* init, void* pose, void* stats, void* h,
    int B, int N, int M, int rounds, float max_d2, float eps_xy, float eps_th,
    float q_perc, float q_adap, float adap_mult, void* stream) {
  int p2 = 1;
  while (p2 < N) p2 <<= 1;
  const int threads = ((N + 31) / 32) * 32;
  const size_t shmem = (size_t)(3 * M + p2) * sizeof(float);
  if (shmem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        plicp_fused_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)shmem);
    if (e != cudaSuccess) return (int)e;
  }
  plicp_fused_kernel<<<B, threads, shmem, (cudaStream_t)stream>>>(
      (const float*)src, (const uint8_t*)src_valid, (const float*)tgt,
      (const uint8_t*)tgt_valid, (const float*)init, (float*)pose,
      (float*)stats, (float*)h, N, M, p2, rounds, max_d2, eps_xy, eps_th,
      q_perc, q_adap, adap_mult);
  return (int)cudaGetLastError();
}
