// The warp-level block cyclic reduction that both CR-LM kernels run
// (cr_lm.cu for K <= 512 supernodes, cr_stream.cu for its wide levels and,
// from level h0 = K / CLUSTER_ACTIVE (128) on, its deep ones, as
// solver/cr_stream.stream_schedule gives them): a warp eliminates one
// supernode, folds its neighbours into one survivor or back-substitutes
// one, on the n x n blocks of a supernode (n = 3W, a template parameter,
// so that a column lives in registers). Every function is templated on
// the kernel's context, which holds K and the device arrays D, B, X1, X2
// (K, n, n) and r, Xr, x (K, n). The library hash in _build.py covers
// this header.

#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace {

namespace cg = cooperative_groups;

constexpr unsigned FULL = 0xffffffffu;

// Shared-memory floats of one warp's slice, the most of its three uses:
// the survivor's five operand blocks and two vectors (5n^2 + 2n); the
// elimination's factor (n rows of stride n | 1), right-hand sides
// (n x (2n + 1)) and pivot reciprocals (n) take less, the
// back-substitution 2n^2 + 2n.
__host__ __device__ constexpr int warp_floats(int n) {
  return 5 * n * n + 2 * n;
}

// Loads of what other blocks wrote: through L2 only (ld.global.cg).
__device__ __forceinline__ float ld(const float* p) { return __ldcg(p); }

// A barrier over the cluster; its arrive releases and its wait acquires
// at cluster scope, so it also publishes this thread's device-memory
// writes to the other blocks.
__device__ __forceinline__ void cluster_barrier() { cg::this_cluster().sync(); }

struct Team {  // this thread's place in the cluster
  int lane, gwarp, nwarps;
  int f0, f1;  // this thread's first flat lane and the end of its block's
};

// In-place lower Cholesky of the N x N matrix A (row stride N | 1) by N
// column steps; lane i holds row i in registers and publishes each new
// entry to A, where the later steps read row j as a broadcast. Leaves the
// pivots' reciprocals in rinv.
template <int N>
__device__ void warp_cholesky(float* A, float* rinv, int lane) {
  constexpr int LD = N | 1;
  const int row = lane < N ? lane : N - 1;
  float a[N];
#pragma unroll
  for (int m = 0; m < N; ++m) a[m] = A[row * LD + m];
#pragma unroll
  for (int j = 0; j < N; ++j) {
    float s = a[j];
#pragma unroll
    for (int m = 0; m < j; ++m) s -= a[m] * A[j * LD + m];
    const float ljj = sqrtf(fmaxf(__shfl_sync(FULL, s, j), 1e-30f));
    a[j] = lane == j ? ljj : s / ljj;
    if (lane >= j && lane < N) A[lane * LD + j] = a[j];
    if (lane == j) rinv[j] = 1.f / ljj;
    __syncwarp();
  }
}

// y <- (L L^T)^-1 y for one column held in registers.
template <int N>
__device__ __forceinline__ void chol_solve(const float* L, const float* rinv,
                                           float (&y)[N]) {
  constexpr int LD = N | 1;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    float s = y[i];
#pragma unroll
    for (int m = 0; m < i; ++m) s -= L[i * LD + m] * y[m];
    y[i] = s * rinv[i];
  }
#pragma unroll
  for (int i = N - 1; i >= 0; --i) {
    float s = y[i];
#pragma unroll
    for (int m = i + 1; m < N; ++m) s -= L[m * LD + i] * y[m];
    y[i] = s * rinv[i];
  }
}

// Eliminate supernode k at level h (left survivor e = k - h): X1, X2, Xr.
template <int N, class Ctx>
__device__ void eliminate(const Ctx& c, int k, int h, float* sm, int lane) {
  constexpr int LD = N | 1, NR = 2 * N + 1, NN = N * N;
  float* A = sm;            // N x LD
  float* R = sm + N * LD;   // N x NR: [B_e^T | B_k | r_k]
  float* rinv = R + N * NR; // N
  const float* D = c.D + (size_t)k * NN;
  const float* Be = c.B + (size_t)(k - h) * NN;
  const float* Bk = c.B + (size_t)k * NN;
#pragma unroll
  for (int t = 0; t < (NN + 31) / 32; ++t) {
    const int q = lane + 32 * t;
    if (q < NN) {
      const int i = q / N, j = q % N;
      const float d = ld(D + q), b = ld(Bk + q), be = ld(Be + q);
      A[i * LD + j] = d;
      R[i * NR + N + j] = b;
      R[j * NR + i] = be;
    }
  }
  if (lane < N) R[lane * NR + 2 * N] = ld(c.r + (size_t)k * N + lane);
  __syncwarp();
  warp_cholesky<N>(A, rinv, lane);
  for (int col = lane; col < NR; col += 32) {
    float y[N];
#pragma unroll
    for (int i = 0; i < N; ++i) y[i] = R[i * NR + col];
    chol_solve<N>(A, rinv, y);
    float* dst = col < N       ? c.X1 + (size_t)k * NN + col
                 : col < 2 * N ? c.X2 + (size_t)k * NN + (col - N)
                               : c.Xr + (size_t)k * N;
    const int stride = col < 2 * N ? N : 1;
#pragma unroll
    for (int i = 0; i < N; ++i) dst[i * stride] = y[i];
  }
  __syncwarp();
}

// Survivor k at level h folds in its eliminated neighbours k - h (when
// there is one) and k + h: D_k <- (D_k - B_{k-h}^T X2_{k-h}) - B_k X1_{k+h},
// r_k likewise with Xr, B_k <- -B_k X2_{k+h} (0 at the chain's end). The
// five operand blocks are staged together; lanes own D's entries
// q = lane + 32 t and r's rows.
template <int N, class Ctx>
__device__ void fold(const Ctx& c, int k, int h, float* sm, int lane) {
  constexpr int NN = N * N, NE = (NN + 31) / 32;
  float* Bl = sm;             // B_{k-h}
  float* X2l = sm + NN;       // X2_{k-h}
  float* Bk = sm + 2 * NN;    // B_k
  float* X1r = sm + 3 * NN;   // X1_{k+h}
  float* X2r = sm + 4 * NN;   // X2_{k+h}
  float* vl = sm + 5 * NN;    // Xr_{k-h}
  float* vr = vl + N;         // Xr_{k+h}
  const bool left = k >= 2 * h;
  const size_t ol = (size_t)(left ? k - h : k), orr = (size_t)(k + h);
  const bool more = k + 2 * h < c.K;
  float* D = c.D + (size_t)k * NN;
  float* B = c.B + (size_t)k * NN;
#pragma unroll
  for (int t = 0; t < NE; ++t) {
    const int q = lane + 32 * t;
    if (q < NN) {
      const float bl = left ? ld(c.B + ol * NN + q) : 0.f;
      const float x2l = left ? ld(c.X2 + ol * NN + q) : 0.f;
      const float bk = ld(B + q);
      const float x1r = ld(c.X1 + orr * NN + q);
      const float x2r = ld(c.X2 + orr * NN + q);
      Bl[q] = bl;
      X2l[q] = x2l;
      Bk[q] = bk;
      X1r[q] = x1r;
      X2r[q] = x2r;
    }
  }
  if (lane < N) {
    vl[lane] = left ? ld(c.Xr + ol * N + lane) : 0.f;
    vr[lane] = ld(c.Xr + orr * N + lane);
  }
  __syncwarp();
#pragma unroll 1  // unrolled, its loads spill registers
  for (int t = 0; t < NE; ++t) {
    const int q = lane + 32 * t;
    if (q < NN) {
      const int i = q / N, j = q % N;
      float sl = 0.f, sr = 0.f, b = 0.f;
      if (left)
#pragma unroll
        for (int m = 0; m < N; ++m) sl += Bl[m * N + i] * X2l[m * N + j];
#pragma unroll
      for (int m = 0; m < N; ++m) {
        sr += Bk[i * N + m] * X1r[m * N + j];
        b += Bk[i * N + m] * X2r[m * N + j];
      }
      D[q] = (ld(D + q) - sl) - sr;
      B[q] = more ? -b : 0.f;
    }
  }
  if (lane < N) {
    float sl = 0.f, sr = 0.f;
    if (left)
#pragma unroll
      for (int m = 0; m < N; ++m) sl += Bl[m * N + lane] * vl[m];
#pragma unroll
    for (int m = 0; m < N; ++m) sr += Bk[lane * N + m] * vr[m];
    float* r = c.r + (size_t)k * N + lane;
    *r = (ld(r) - sl) - sr;
  }
  __syncwarp();
}

// Back-substitution of supernode k at level h:
// x_k = Xr_k - X1_k x_{k-h} - X2_k x_{k+h} (no right term at the end).
template <int N, class Ctx>
__device__ void back_substitute(const Ctx& c, int k, int h, float* sm,
                                int lane) {
  constexpr int NN = N * N;
  float* S0 = sm;
  float* S1 = sm + NN;
  float* v = sm + 2 * NN;
  const int e = k - h, g = k + h;
  const bool right = g < c.K;
#pragma unroll
  for (int t = 0; t < (NN + 31) / 32; ++t) {
    const int q = lane + 32 * t;
    if (q < NN) {
      const float x1 = ld(c.X1 + (size_t)k * NN + q);
      const float x2 = right ? ld(c.X2 + (size_t)k * NN + q) : 0.f;
      S0[q] = x1;
      S1[q] = x2;
    }
  }
  if (lane < N) {
    v[lane] = ld(c.x + (size_t)e * N + lane);
    if (right) v[N + lane] = ld(c.x + (size_t)g * N + lane);
  }
  __syncwarp();
  if (lane < N) {
    float s = ld(c.Xr + (size_t)k * N + lane);
#pragma unroll
    for (int m = 0; m < N; ++m) s -= S0[lane * N + m] * v[m];
    if (right)
#pragma unroll
      for (int m = 0; m < N; ++m) s -= S1[lane * N + m] * v[N + m];
    c.x[(size_t)k * N + lane] = s;
  }
  __syncwarp();
}

// x <- H^-1 r by block cyclic reduction (banded.cr_solve's order) from
// level h0 on, a warp per active supernode across the cluster: the levels
// h0, 2 h0, ..., K / 2, the top solve of supernode 0, and the
// back-substitution down to level h0. The levels below h0 (cr_stream.cu's
// wide ones) have run before and are back-substituted after; with h0 = 1
// this is the whole solve.
template <int N, class Ctx>
__device__ void cr_solve(const Ctx& c, const Team& t, float* sm, int h0) {
  const int K = c.K;
  int h = h0;
  for (; h < K; h <<= 1) {
    const int cnt = K / (2 * h);  // eliminations and survivors alike
    for (int j = t.gwarp; j < cnt; j += t.nwarps)
      eliminate<N>(c, h * (2 * j + 1), h, sm, t.lane);
    cluster_barrier();
    for (int j = t.gwarp; j < cnt; j += t.nwarps)
      fold<N>(c, 2 * h * j, h, sm, t.lane);
    cluster_barrier();
  }
  // top: x_0 = D_0^-1 r_0
  if (t.gwarp == 0) {
    constexpr int LD = N | 1;
    float* rinv = sm + N * LD;
    for (int q = t.lane; q < N * N; q += 32)
      sm[(q / N) * LD + q % N] = ld(c.D + q);
    __syncwarp();
    warp_cholesky<N>(sm, rinv, t.lane);
    if (t.lane == 0) {
      float y[N];
#pragma unroll
      for (int i = 0; i < N; ++i) y[i] = ld(c.r + i);
      chol_solve<N>(sm, rinv, y);
#pragma unroll
      for (int i = 0; i < N; ++i) c.x[i] = y[i];
    }
    __syncwarp();
  }
  cluster_barrier();
  // back-substitution, top level down
  for (h >>= 1; h >= h0; h >>= 1) {
    const int cnt = K / (2 * h);
    for (int j = t.gwarp; j < cnt; j += t.nwarps)
      back_substitute<N>(c, h * (2 * j + 1), h, sm, t.lane);
    cluster_barrier();
  }
}

}  // namespace
