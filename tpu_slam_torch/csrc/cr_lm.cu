// The whole doSPA Levenberg-Marquardt solve of a banded pose graph, with an
// exact block cyclic-reduction (CR) factorization, in one launch.
//
// Replaces: tpu_slam/solver/pallas_cr_lm.py::fused_cr_lm (Pallas kernel
// _make_kernel).
//
// What bounds it on the H100: latency, not bytes or FLOPs. One LM step on
// the mission graph (W = 4, K = 256 supernodes of n = 3W = 12 unknowns) is
// a few MFLOP, but CR is log2(K) dependent levels, each a chain of small
// dense n x n Cholesky factorizations, triangular solves and products,
// and the LM loop is a chain of such steps with a cost reduction and an
// accept/reject decision between them.
//
// Design: one thread block per solve, one thread per supernode lane
// (K <= K_MAX = 512 threads; the launch bound caps the registers so that
// 512 threads fit an SM), so every level is one __syncthreads() apart and
// the LM loop never leaves the kernel. The per-supernode blocks D, B
// (coupling to the next active supernode), the stored eliminations
// X1 = D^-1 B_prev^T, X2 = D^-1 B, Xr = D^-1 r and the right-hand sides
// live in device memory laid out as [row][col][supernode], so the K
// threads touch consecutive addresses and the ~1-4 MB working set stays in
// L2. Assembly is per flat lane f = a K + k (node a of supernode k); the
// contributions that land on another supernode go through a staging array
// and are gathered by their owner, so every sum has a fixed order and no
// atomics are needed. The TPU kernel's lane rolls, masked-sublane
// extraction and VMEM gate are Mosaic workarounds and are not carried over.

#include "cr_edges.cuh"

namespace {

struct Ctx {
  int W, K, n, WK;
  const float* slots;  // (NBANKS * W * SLOT_ROWS, WK)
  const float* free;   // (WK,)
  float* P;            // (3, WK) current poses
  float* C;            // (3, WK) candidate poses
  float* D;            // (n, n, K)
  float* B;            // (n, n, K)
  float* X1;           // (n, n, K)
  float* X2;           // (n, n, K)
  float* r;            // (n, K)
  float* Xr;           // (n, K)
  float* x;            // (n, K)
  float* stage;        // (NBANKS * W * STAGE_ROWS, WK)
};

__device__ __forceinline__ float& M(float* m, const Ctx& c, int i, int j,
                                    int k) {
  return m[((size_t)i * c.n + j) * c.K + k];
}

// chi^2 of the whole graph at poses P (sum over this thread's lanes, then
// over the block).
__device__ float graph_cost(const Ctx& c, const float* P, float* red) {
  const int k = threadIdx.x;
  float acc = 0.f;
  Edge e;
  for (int a = 0; a < c.W; ++a)
    for (int bank = 0; bank < NBANKS; ++bank)
      for (int d = 1; d <= c.W; ++d)
        if (edge_terms(c, P, bank, d, a, k, e)) acc += edge_cost(e);
  return block_sum(acc, red);
}

// D, B, r of supernode k (this thread) at poses P, damped by lam and
// gauge-fixed (banded.assemble_supernodes semantics).
__device__ void assemble(const Ctx& c, float lam) {
  const int k = threadIdx.x, n = c.n, W = c.W, K = c.K;
  for (int i = 0; i < n; ++i) {
    for (int j = 0; j < n; ++j) {
      M(c.D, c, i, j, k) = 0.f;
      M(c.B, c, i, j, k) = 0.f;
    }
    c.r[i * K + k] = 0.f;
  }
  Edge e;
  float HLL[3][3], HLH[3][3], HHH[3][3], bL[3], bH[3];
  for (int a = 0; a < W; ++a)
    for (int bank = 0; bank < NBANKS; ++bank)
      for (int d = 1; d <= W; ++d) {
        if (!edge_terms(c, c.P, bank, d, a, k, e)) continue;
        edge_blocks(e, HLL, HLH, HHH, bL, bH);
        const int bo = a + d;
        for (int u = 0; u < 3; ++u) {
          for (int v = 0; v < 3; ++v) {
            M(c.D, c, 3 * a + u, 3 * a + v, k) += HLL[u][v];
            if (bo < W) {
              M(c.D, c, 3 * a + u, 3 * bo + v, k) += HLH[u][v];
              M(c.D, c, 3 * bo + v, 3 * a + u, k) += HLH[u][v];
            } else {
              M(c.B, c, 3 * a + u, 3 * (bo - W) + v, k) += HLH[u][v];
            }
          }
          c.r[(3 * a + u) * K + k] += bL[u];
        }
        // the high node's share goes to its owner through the stage
        float* st = c.stage +
                    (size_t)((bank * W + d - 1) * STAGE_ROWS) * c.WK +
                    a * K + k;
        for (int u = 0; u < 3; ++u) {
          for (int v = 0; v < 3; ++v) st[(size_t)(3 * u + v) * c.WK] = HHH[u][v];
          st[(size_t)(9 + u) * c.WK] = bH[u];
        }
      }
  __syncthreads();
  for (int a = 0; a < W; ++a) {
    const int p = k * W + a;  // chain position of this node
    for (int bank = 0; bank < NBANKS; ++bank)
      for (int d = 1; d <= W; ++d) {
        const int pl = p - d;
        if (pl < 0) continue;
        const int fl = (pl % W) * K + pl / W;
        const float* sl =
            c.slots + (size_t)((bank * W + d - 1) * SLOT_ROWS) * c.WK + fl;
        bool any = false;
        for (int q = 0; q < 6; ++q) any |= sl[(size_t)(3 + q) * c.WK] != 0.f;
        if (!any) continue;
        const float* st =
            c.stage + (size_t)((bank * W + d - 1) * STAGE_ROWS) * c.WK + fl;
        for (int u = 0; u < 3; ++u) {
          for (int v = 0; v < 3; ++v)
            M(c.D, c, 3 * a + u, 3 * a + v, k) += st[(size_t)(3 * u + v) * c.WK];
          c.r[(3 * a + u) * K + k] += st[(size_t)(9 + u) * c.WK];
        }
      }
  }
  // damping (jitter, then x (1 + lambda) on the diagonal) and the gauge /
  // padding mask: rows and columns of non-free nodes zeroed, identity diag
  const float one_lam = 1.f + lam;
  for (int i = 0; i < n; ++i) {
    float& dii = M(c.D, c, i, i, k);
    dii = (dii + 1e-12f) * one_lam;
  }
  const int kn = (k + 1) % K;
  for (int i = 0; i < n; ++i) {
    const float fi = c.free[(i / 3) * K + k];
    for (int j = 0; j < n; ++j) {
      M(c.D, c, i, j, k) *= fi * c.free[(j / 3) * K + k];
      M(c.B, c, i, j, k) *= fi * c.free[(j / 3) * K + kn];
    }
    M(c.D, c, i, i, k) += 1.f - fi;
    c.r[i * K + k] = -c.r[i * K + k] * fi;
  }
}

// In-place lower Cholesky of D at lane k.
__device__ void cholesky(const Ctx& c, int k) {
  const int n = c.n;
  for (int j = 0; j < n; ++j) {
    float s = M(c.D, c, j, j, k);
    for (int m = 0; m < j; ++m) {
      const float l = M(c.D, c, j, m, k);
      s -= l * l;
    }
    const float ljj = sqrtf(fmaxf(s, 1e-30f));
    M(c.D, c, j, j, k) = ljj;
    for (int i = j + 1; i < n; ++i) {
      float t = M(c.D, c, i, j, k);
      for (int m = 0; m < j; ++m) t -= M(c.D, c, i, m, k) * M(c.D, c, j, m, k);
      M(c.D, c, i, j, k) = t / ljj;
    }
  }
}

// y <- (L L^T)^-1 y for one column y (entry i at y[i * stride]).
__device__ void chol_solve(const Ctx& c, int k, float* y, size_t stride) {
  const int n = c.n;
  for (int i = 0; i < n; ++i) {
    float t = y[i * stride];
    for (int m = 0; m < i; ++m) t -= M(c.D, c, i, m, k) * y[m * stride];
    y[i * stride] = t / M(c.D, c, i, i, k);
  }
  for (int i = n - 1; i >= 0; --i) {
    float t = y[i * stride];
    for (int m = i + 1; m < n; ++m) t -= M(c.D, c, m, i, k) * y[m * stride];
    y[i * stride] = t / M(c.D, c, i, i, k);
  }
}

// x <- H^-1 r by block cyclic reduction (banded.cr_solve's order).
__device__ void cr_solve(const Ctx& c) {
  const int k = threadIdx.x, n = c.n, K = c.K;
  const size_t col = (size_t)n * K;  // stride between rows of a matrix
  int h = 1;
  for (; h < K; h <<= 1) {
    if ((k & (2 * h - 1)) == h) {  // eliminated at this level
      const int e = k - h;
      cholesky(c, k);
      for (int i = 0; i < n; ++i) {
        for (int j = 0; j < n; ++j) {
          M(c.X1, c, i, j, k) = M(c.B, c, j, i, e);
          M(c.X2, c, i, j, k) = M(c.B, c, i, j, k);
        }
        c.Xr[i * K + k] = c.r[i * K + k];
      }
      for (int j = 0; j < n; ++j) {
        chol_solve(c, k, &M(c.X1, c, 0, j, k), col);
        chol_solve(c, k, &M(c.X2, c, 0, j, k), col);
      }
      chol_solve(c, k, &c.Xr[k], K);
    }
    __syncthreads();
    if ((k & (2 * h - 1)) == 0) {  // survivor: fold in both neighbours
      if (k >= 2 * h) {  // from the eliminated supernode on the left
        const int o = k - h;
        for (int i = 0; i < n; ++i) {
          for (int j = 0; j < n; ++j) {
            float t = 0.f;
            for (int m = 0; m < n; ++m)
              t += M(c.B, c, m, i, o) * M(c.X2, c, m, j, o);
            M(c.D, c, i, j, k) -= t;
          }
          float t = 0.f;
          for (int m = 0; m < n; ++m) t += M(c.B, c, m, i, o) * c.Xr[m * K + o];
          c.r[i * K + k] -= t;
        }
      }
      const int o = k + h;  // from the eliminated supernode on the right
      const bool more = o + h < K;
      float row[24];
      for (int i = 0; i < n; ++i) {
        for (int j = 0; j < n; ++j) {
          float t = 0.f;
          for (int m = 0; m < n; ++m)
            t += M(c.B, c, i, m, k) * M(c.X1, c, m, j, o);
          M(c.D, c, i, j, k) -= t;
        }
        float t = 0.f;
        for (int m = 0; m < n; ++m) t += M(c.B, c, i, m, k) * c.Xr[m * K + o];
        c.r[i * K + k] -= t;
        // new coupling to supernode k + 2h: -B_k X2_o (row i needs only
        // row i of the old B_k)
        for (int j = 0; j < n; ++j) {
          float s = 0.f;
          if (more)
            for (int m = 0; m < n; ++m)
              s += M(c.B, c, i, m, k) * M(c.X2, c, m, j, o);
          row[j] = -s;
        }
        for (int j = 0; j < n; ++j) M(c.B, c, i, j, k) = row[j];
      }
    }
    __syncthreads();
  }
  // top: x_0 = D_0^-1 r_0
  if (k == 0) {
    cholesky(c, 0);
    for (int i = 0; i < n; ++i) c.x[i * K] = c.r[i * K];
    chol_solve(c, 0, &c.x[0], K);
  }
  __syncthreads();
  // back-substitution, top level down
  for (h >>= 1; h >= 1; h >>= 1) {
    if ((k & (2 * h - 1)) == h) {
      const int e = k - h, g = k + h;
      float row[24];
      for (int i = 0; i < n; ++i) {
        float t = c.Xr[i * K + k];
        for (int m = 0; m < n; ++m) t -= M(c.X1, c, i, m, k) * c.x[m * K + e];
        if (g < K)
          for (int m = 0; m < n; ++m) t -= M(c.X2, c, i, m, k) * c.x[m * K + g];
        row[i] = t;
      }
      for (int i = 0; i < n; ++i) c.x[i * K + k] = row[i];
    }
    __syncthreads();
  }
}

constexpr int K_MAX = 512;  // solver/cr_lm.py K_MAX

__global__ void __launch_bounds__(K_MAX) cr_lm_kernel(const float* __restrict__ pT8,
                             const float* __restrict__ slots,
                             float* __restrict__ out, float* scratch,
                             float lam0, int W, int K, int iters,
                             float sq_min_delta) {
  __shared__ float red[33];
  Ctx c;
  c.W = W;
  c.K = K;
  c.n = 3 * W;
  c.WK = W * K;
  const int n = c.n, WK = c.WK;
  const size_t nnK = (size_t)n * n * K, nK = (size_t)n * K;
  c.slots = slots;
  c.free = pT8 + 3 * WK;
  c.P = scratch;
  c.C = c.P + 3 * WK;
  c.D = c.C + 3 * WK;
  c.B = c.D + nnK;
  c.X1 = c.B + nnK;
  c.X2 = c.X1 + nnK;
  c.r = c.X2 + nnK;
  c.Xr = c.r + nK;
  c.x = c.Xr + nK;
  c.stage = c.x + nK;

  const int k = threadIdx.x;
  for (int a = 0; a < W; ++a)
    for (int u = 0; u < 3; ++u) c.P[u * WK + a * K + k] = pT8[u * WK + a * K + k];
  __syncthreads();

  const float cost0 = graph_cost(c, c.P, red);
  float lam = lam0, laminc = 2.f, cost = cost0, good = 0.f;
  int it = 0;
  bool done = false;
  while (it < iters && !done) {
    assemble(c, lam);
    cr_solve(c);
    float sq = 0.f;
    for (int a = 0; a < W; ++a) {
      const int f = a * K + k;
      for (int u = 0; u < 3; ++u) {
        const float dl = c.x[(3 * a + u) * K + k] * c.free[f];
        sq += dl * dl;
        const float v = c.P[u * WK + f] + dl;
        c.C[u * WK + f] = u == 2 ? wrap(v) : v;
      }
    }
    sq = block_sum(sq, red);  // also publishes C to the other threads
    const bool converged = sq < sq_min_delta;
    const float new_cost = graph_cost(c, c.C, red);
    const bool accept = new_cost < cost && !converged;
    if (accept) {
      for (int a = 0; a < W; ++a)
        for (int u = 0; u < 3; ++u)
          c.P[u * WK + a * K + k] = c.C[u * WK + a * K + k];
      cost = new_cost;
      lam = lam * 0.5f;
      good += 1.f;
    } else {
      lam = lam * laminc;
      laminc = laminc * 2.f;
    }
    ++it;
    done = converged;
    __syncthreads();
  }
  for (int a = 0; a < W; ++a) {
    const int f = a * K + k;
    for (int u = 0; u < 3; ++u) out[u * WK + f] = c.P[u * WK + f];
    float s = 0.f;
    if (f == 0) s = cost0;
    if (f == 1) s = cost;
    if (f == 2) s = good;
    if (f == 3) s = (float)it;
    out[3 * WK + f] = s;
    for (int u = 4; u < 8; ++u) out[u * WK + f] = 0.f;
  }
}

}  // namespace

extern "C" int cr_lm_launch(const void* pT8, const void* slots, void* out,
                            void* scratch, float lam0, int W, int K,
                            int iters, float sq_min_delta, void* stream) {
  cr_lm_kernel<<<1, K, 0, (cudaStream_t)stream>>>(
      (const float*)pT8, (const float*)slots, (float*)out, (float*)scratch,
      lam0, W, K, iters, sq_min_delta);
  return (int)cudaGetLastError();
}
