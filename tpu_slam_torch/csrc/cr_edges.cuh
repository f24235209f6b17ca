// What the two CR-LM kernels (cr_lm.cu, cr_stream.cu) share: the slot
// layout of the banded graph, each edge's residual, Jacobian blocks and
// chi^2 at a flat lane, the heading wrap and a fixed-order block sum.
// The library hash in _build.py covers this header.

#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int NBANKS = 2;
constexpr int SLOT_ROWS = 10;
constexpr int STAGE_ROWS = 12;  // 9 H entries + 3 b entries per edge

__device__ __forceinline__ float wrap(float th) {
  return th - 6.283185307179586f *
                  floorf((th + 3.141592653589793f) / 6.283185307179586f);
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  return v;
}

// Block-wide sum in a fixed order; every thread gets the total.
__device__ float block_sum(float v, float* red) {
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  v = warp_sum(v);
  if (lane == 0) red[wid] = v;
  __syncthreads();
  if (threadIdx.x == 0) {
    float s = 0.f;
    for (int w = 0; w < (int)(blockDim.x >> 5); ++w) s += red[w];
    red[32] = s;
  }
  __syncthreads();
  const float out = red[32];
  __syncthreads();
  return out;
}

struct Edge {
  float W6[6];
  bool flip;
  float c, s, drx, dry, r[3];
};

// A load of a float; with L2 = true through L2 only (ld.global.cg), for
// data that another block of the cluster wrote since the last barrier.
template <bool L2>
__device__ __forceinline__ float load(const float* p) {
  if constexpr (L2) return __ldcg(p);
  return *p;
}

// Residual and Jacobian terms of the edge in slot (bank, d) at flat lane
// f = a K + k (its low node), poses P (3, WK); false when the slot is
// empty. Ctx holds the slots (NBANKS * W * SLOT_ROWS, WK), W, K and WK.
// L2: read the poses through L2 (see load).
template <class Ctx, bool L2 = false>
__device__ bool edge_terms(const Ctx& c, const float* P, int bank, int d,
                           int a, int k, Edge& e) {
  const int f = a * c.K + k;
  const float* sl =
      c.slots + (size_t)((bank * c.W + d - 1) * SLOT_ROWS) * c.WK + f;
  bool any = false;
  for (int q = 0; q < 6; ++q) {
    e.W6[q] = sl[(size_t)(3 + q) * c.WK];
    any |= e.W6[q] != 0.f;
  }
  const int a2 = a + d;
  const int k2 = k + a2 / c.W;
  if (!any || k2 >= c.K) return false;
  const int fh = (a2 % c.W) * c.K + k2;
  e.flip = sl[(size_t)9 * c.WK] > 0.5f;
  const int fa = e.flip ? fh : f, fb = e.flip ? f : fh;
  const float ax = load<L2>(P + fa), ay = load<L2>(P + c.WK + fa);
  const float at = load<L2>(P + 2 * c.WK + fa);
  const float bx = load<L2>(P + fb), by = load<L2>(P + c.WK + fb);
  const float bt = load<L2>(P + 2 * c.WK + fb);
  e.c = cosf(at);
  e.s = sinf(at);
  const float dx = bx - ax, dy = by - ay;
  e.r[0] = e.c * dx + e.s * dy - sl[0];
  e.r[1] = -e.s * dx + e.c * dy - sl[(size_t)c.WK];
  e.r[2] = wrap(bt - at - sl[(size_t)2 * c.WK]);
  e.drx = -e.s * dx + e.c * dy;
  e.dry = -e.c * dx - e.s * dy;
  return true;
}

__device__ float edge_cost(const Edge& e) {
  const float* w = e.W6;
  const float r0 = e.r[0], r1 = e.r[1], r2 = e.r[2];
  return w[0] * r0 * r0 + 2.f * w[1] * r0 * r1 + 2.f * w[2] * r0 * r2 +
         w[3] * r1 * r1 + 2.f * w[4] * r1 * r2 + w[5] * r2 * r2;
}

// Edge blocks: J_L / J_H are the Jacobians wrt the low / high node.
__device__ void edge_blocks(const Edge& e, float HLL[3][3], float HLH[3][3],
                            float HHH[3][3], float bL[3], float bH[3]) {
  const float Ja[3][3] = {{-e.c, -e.s, e.drx}, {e.s, -e.c, e.dry},
                          {0.f, 0.f, -1.f}};
  const float Jb[3][3] = {{e.c, e.s, 0.f}, {-e.s, e.c, 0.f}, {0.f, 0.f, 1.f}};
  const float(*JL)[3] = e.flip ? Jb : Ja;
  const float(*JH)[3] = e.flip ? Ja : Jb;
  const float O[3][3] = {{e.W6[0], e.W6[1], e.W6[2]},
                         {e.W6[1], e.W6[3], e.W6[4]},
                         {e.W6[2], e.W6[4], e.W6[5]}};
  float LW[3][3], HW[3][3];  // J^T Omega
  for (int u = 0; u < 3; ++u)
    for (int m = 0; m < 3; ++m) {
      LW[u][m] = JL[0][u] * O[0][m] + JL[1][u] * O[1][m] + JL[2][u] * O[2][m];
      HW[u][m] = JH[0][u] * O[0][m] + JH[1][u] * O[1][m] + JH[2][u] * O[2][m];
    }
  for (int u = 0; u < 3; ++u) {
    for (int v = 0; v < 3; ++v) {
      HLL[u][v] = LW[u][0] * JL[0][v] + LW[u][1] * JL[1][v] + LW[u][2] * JL[2][v];
      HLH[u][v] = LW[u][0] * JH[0][v] + LW[u][1] * JH[1][v] + LW[u][2] * JH[2][v];
      HHH[u][v] = HW[u][0] * JH[0][v] + HW[u][1] * JH[1][v] + HW[u][2] * JH[2][v];
    }
    bL[u] = LW[u][0] * e.r[0] + LW[u][1] * e.r[1] + LW[u][2] * e.r[2];
    bH[u] = HW[u][0] * e.r[0] + HW[u][1] * e.r[1] + HW[u][2] * e.r[2];
  }
}

}  // namespace
