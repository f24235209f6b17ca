// The whole doSPA Levenberg-Marquardt solve with an inner block-Jacobi
// preconditioned conjugate-gradient (PCG) step, in one launch.
//
// Replaces: tpu_slam/solver/pallas_lm.py::fused_lm_solve (Pallas kernel
// _make_kernel).
//
// What bounds it on the H100: latency. A mission graph (~1k nodes, ~1.2k
// edges) is ~100 KB; one PCG iteration is a few 10k FLOPs, but every
// iteration is a gather over the edges, a scatter back to the nodes and
// three global dot products, each a block-wide synchronisation, and up to
// cg_iters x iters of them run back to back.
//
// Design: one thread block of 1024 threads runs the whole solve, so each
// dependency is a __syncthreads() instead of a kernel launch, and the LM
// accept/reject loop never leaves the kernel. Threads stride over edges
// and nodes. The TPU kernel's (E, M) one-hot gather/scatter matmuls become
// direct gathers, and the scatters become per-node sums over a CSR list of
// incident edges (built on the host), so every sum has a fixed order and
// no atomics are needed. Node and edge arrays are component-major so that
// neighbouring threads touch neighbouring addresses. PCG stops as soon as
// ||r||^2 <= cg_tol ||b||^2, which is where the reference's masked
// iterations stop changing anything.

#include <cuda_runtime.h>
#include <math.h>

namespace {

struct Ctx {
  int M, E;
  const float* meansT;  // (3, E)
  const float* W6;      // (6, E) information upper triangle, mask-weighted
  const float* fm;      // (M,) 1 = free
  const int* ei;
  const int* ej;
  const int* row_ptr;  // (M + 1,)
  const int* inc;      // (2E,) 2 * edge + role
  float* P;            // (3, M) current poses
  float* C;            // (3, M) candidate poses
  float* d6;           // (6, M) damped, gauge-fixed diagonal blocks
  float* mi6;          // (6, M) their inverses (preconditioner)
  float* b3;           // (3, M)
  float* x;            // (3, M)
  float* r;            // (3, M)
  float* z;            // (3, M)
  float* p;            // (3, M)
  float* Ap;           // (3, M)
  float* Hij9;         // (9, E)
  float* Hii6;         // (6, E)
  float* Hjj6;         // (6, E)
  float* bi3;          // (3, E)
  float* bj3;          // (3, E)
  float* uv6;          // (6, E) matvec edge products
};

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

struct Terms {
  float c, s, drx, dry, r[3];
};

__device__ Terms edge_terms(const Ctx& k, const float* P, int e) {
  const int i = k.ei[e], j = k.ej[e];
  const int M = k.M, E = k.E;
  const float ti = P[2 * M + i];
  Terms t;
  t.c = cosf(ti);
  t.s = sinf(ti);
  const float dx = P[j] - P[i], dy = P[M + j] - P[M + i];
  t.r[0] = t.c * dx + t.s * dy - k.meansT[e];
  t.r[1] = -t.s * dx + t.c * dy - k.meansT[E + e];
  t.r[2] = wrap(P[2 * M + j] - ti - k.meansT[2 * E + e]);
  t.drx = -t.s * dx + t.c * dy;
  t.dry = -t.c * dx - t.s * dy;
  return t;
}

__device__ float graph_cost(const Ctx& k, const float* P, float* red) {
  float acc = 0.f;
  for (int e = threadIdx.x; e < k.E; e += blockDim.x) {
    const Terms t = edge_terms(k, P, e);
    const float* w = k.W6 + e;
    const int E = k.E;
    const float r0 = t.r[0], r1 = t.r[1], r2 = t.r[2];
    acc += w[0] * r0 * r0 + 2.f * w[E] * r0 * r1 + 2.f * w[2 * E] * r0 * r2 +
           w[3 * E] * r1 * r1 + 2.f * w[4 * E] * r1 * r2 + w[5 * E] * r2 * r2;
  }
  return block_sum(acc, red);
}

// index of (u, v) in the 6-entry upper triangle
__device__ __forceinline__ int up6(int u, int v) {
  const int a = u < v ? u : v, b = u < v ? v : u;
  return a == 0 ? b : (a == 1 ? 2 + b : 5);
}

// Normal equations at P, damped by lam and gauge-fixed; fills d6, mi6,
// b3 and Hij9.
__device__ void normal_eq(const Ctx& k, float lam) {
  const int E = k.E, M = k.M;
  for (int e = threadIdx.x; e < E; e += blockDim.x) {
    const Terms t = edge_terms(k, k.P, e);
    const float Ji[3][3] = {{-t.c, -t.s, t.drx}, {t.s, -t.c, t.dry},
                            {0.f, 0.f, -1.f}};
    const float Jj[3][3] = {{t.c, t.s, 0.f}, {-t.s, t.c, 0.f},
                            {0.f, 0.f, 1.f}};
    const float* w = k.W6 + e;
    const float O[3][3] = {{w[0], w[E], w[2 * E]},
                           {w[E], w[3 * E], w[4 * E]},
                           {w[2 * E], w[4 * E], w[5 * E]}};
    float IW[3][3], JW[3][3];  // J^T Omega
    for (int u = 0; u < 3; ++u)
      for (int m = 0; m < 3; ++m) {
        IW[u][m] = Ji[0][u] * O[0][m] + Ji[1][u] * O[1][m] + Ji[2][u] * O[2][m];
        JW[u][m] = Jj[0][u] * O[0][m] + Jj[1][u] * O[1][m] + Jj[2][u] * O[2][m];
      }
    for (int u = 0; u < 3; ++u) {
      for (int v = 0; v < 3; ++v) {
        k.Hij9[(3 * u + v) * E + e] =
            IW[u][0] * Jj[0][v] + IW[u][1] * Jj[1][v] + IW[u][2] * Jj[2][v];
        if (v >= u) {
          k.Hii6[up6(u, v) * E + e] =
              IW[u][0] * Ji[0][v] + IW[u][1] * Ji[1][v] + IW[u][2] * Ji[2][v];
          k.Hjj6[up6(u, v) * E + e] =
              JW[u][0] * Jj[0][v] + JW[u][1] * Jj[1][v] + JW[u][2] * Jj[2][v];
        }
      }
      k.bi3[u * E + e] = IW[u][0] * t.r[0] + IW[u][1] * t.r[1] + IW[u][2] * t.r[2];
      k.bj3[u * E + e] = JW[u][0] * t.r[0] + JW[u][1] * t.r[1] + JW[u][2] * t.r[2];
    }
  }
  __syncthreads();
  const float one_lam = 1.f + lam;
  for (int m = threadIdx.x; m < M; m += blockDim.x) {
    float h[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f}, b[3] = {0.f, 0.f, 0.f};
    for (int q = k.row_ptr[m]; q < k.row_ptr[m + 1]; ++q) {
      const int e = k.inc[q] >> 1;
      const float* hs = (k.inc[q] & 1) ? k.Hjj6 : k.Hii6;
      const float* bs = (k.inc[q] & 1) ? k.bj3 : k.bi3;
      for (int u = 0; u < 6; ++u) h[u] += hs[u * E + e];
      for (int u = 0; u < 3; ++u) b[u] += bs[u * E + e];
    }
    const float f = k.fm[m], nf = 1.f - f;
    const float d00 = ((h[0] + 1e-12f) * one_lam) * f + nf;
    const float d11 = ((h[3] + 1e-12f) * one_lam) * f + nf;
    const float d22 = ((h[5] + 1e-12f) * one_lam) * f + nf;
    const float d01 = h[1] * f, d02 = h[2] * f, d12 = h[4] * f;
    const float dd[6] = {d00, d01, d02, d11, d12, d22};
    for (int u = 0; u < 6; ++u) k.d6[u * M + m] = dd[u];
    // block-Jacobi inverse by cofactors
    const float c00 = d11 * d22 - d12 * d12;
    const float c01 = d02 * d12 - d01 * d22;
    const float c02 = d01 * d12 - d02 * d11;
    const float det = d00 * c00 + d01 * c01 + d02 * c02;
    const float inv_det = 1.f / (fabsf(det) > 1e-30f ? det : 1.f);
    const float mi[6] = {c00 * inv_det, c01 * inv_det, c02 * inv_det,
                         (d00 * d22 - d02 * d02) * inv_det,
                         (d02 * d01 - d00 * d12) * inv_det,
                         (d00 * d11 - d01 * d01) * inv_det};
    for (int u = 0; u < 6; ++u) k.mi6[u * M + m] = mi[u];
    for (int u = 0; u < 3; ++u) k.b3[u * M + m] = b[u];
  }
  __syncthreads();
}

// y = S v for the symmetric 3x3 S stored as 6 entries at stride M
__device__ __forceinline__ void sym3(const float* s, int M, int m,
                                     const float v[3], float y[3]) {
  const float s00 = s[m], s01 = s[M + m], s02 = s[2 * M + m];
  const float s11 = s[3 * M + m], s12 = s[4 * M + m], s22 = s[5 * M + m];
  y[0] = s00 * v[0] + s01 * v[1] + s02 * v[2];
  y[1] = s01 * v[0] + s11 * v[1] + s12 * v[2];
  y[2] = s02 * v[0] + s12 * v[1] + s22 * v[2];
}

// Ap = H p on the gauge-fixed system (cg_matvec semantics).
__device__ void matvec(const Ctx& k) {
  const int E = k.E, M = k.M;
  for (int e = threadIdx.x; e < E; e += blockDim.x) {
    const int i = k.ei[e], j = k.ej[e];
    const float fi = k.fm[i], fj = k.fm[j];
    const float xi[3] = {k.p[i] * fi, k.p[M + i] * fi, k.p[2 * M + i] * fi};
    const float xj[3] = {k.p[j] * fj, k.p[M + j] * fj, k.p[2 * M + j] * fj};
    const float* H = k.Hij9 + e;
    for (int u = 0; u < 3; ++u) {
      k.uv6[u * E + e] = H[(3 * u) * E] * xj[0] + H[(3 * u + 1) * E] * xj[1] +
                         H[(3 * u + 2) * E] * xj[2];
      k.uv6[(3 + u) * E + e] = H[u * E] * xi[0] + H[(3 + u) * E] * xi[1] +
                               H[(6 + u) * E] * xi[2];
    }
  }
  __syncthreads();
  for (int m = threadIdx.x; m < M; m += blockDim.x) {
    const float f = k.fm[m];
    const float xm[3] = {k.p[m] * f, k.p[M + m] * f, k.p[2 * M + m] * f};
    float y[3];
    sym3(k.d6, M, m, xm, y);
    for (int q = k.row_ptr[m]; q < k.row_ptr[m + 1]; ++q) {
      const int e = k.inc[q] >> 1, off = (k.inc[q] & 1) ? 3 : 0;
      for (int u = 0; u < 3; ++u) y[u] += k.uv6[(off + u) * E + e];
    }
    for (int u = 0; u < 3; ++u) k.Ap[u * M + m] = y[u] * f + xm[u] * (1.f - f);
  }
}

// x <- PCG solution of H x = -b (block-Jacobi preconditioner); returns
// the number of iterations run.
__device__ int pcg(const Ctx& k, int cg_iters, float cg_tol, float* red) {
  const int M = k.M;
  float bb2 = 0.f, rz0 = 0.f;
  for (int m = threadIdx.x; m < M; m += blockDim.x) {
    const float f = k.fm[m];
    float rv[3], zv[3];
    for (int u = 0; u < 3; ++u) {
      rv[u] = -k.b3[u * M + m] * f;
      k.x[u * M + m] = 0.f;
      k.r[u * M + m] = rv[u];
      bb2 += rv[u] * rv[u];
    }
    sym3(k.mi6, M, m, rv, zv);
    for (int u = 0; u < 3; ++u) {
      k.z[u * M + m] = zv[u];
      k.p[u * M + m] = zv[u];
      rz0 += rv[u] * zv[u];
    }
  }
  const float stop2 = cg_tol * block_sum(bb2, red);
  float rz = block_sum(rz0, red);
  float rr = block_sum(bb2, red);  // r starts at -b
  int it = 0;
  for (; it < cg_iters && rr > stop2; ++it) {
    matvec(k);
    float pap = 0.f;
    for (int m = threadIdx.x; m < M; m += blockDim.x)
      for (int u = 0; u < 3; ++u) pap += k.p[u * M + m] * k.Ap[u * M + m];
    pap = block_sum(pap, red);
    const float alpha = rz / (pap != 0.f ? pap : 1.f);
    float rzn = 0.f, rrn = 0.f;
    for (int m = threadIdx.x; m < M; m += blockDim.x) {
      float rv[3], zv[3];
      for (int u = 0; u < 3; ++u) {
        k.x[u * M + m] += alpha * k.p[u * M + m];
        rv[u] = k.r[u * M + m] - alpha * k.Ap[u * M + m];
        k.r[u * M + m] = rv[u];
        rrn += rv[u] * rv[u];
      }
      sym3(k.mi6, M, m, rv, zv);
      for (int u = 0; u < 3; ++u) {
        k.z[u * M + m] = zv[u];
        rzn += rv[u] * zv[u];
      }
    }
    rzn = block_sum(rzn, red);
    const float beta = rzn / (rz != 0.f ? rz : 1.f);
    for (int m = threadIdx.x; m < M; m += blockDim.x)
      for (int u = 0; u < 3; ++u)
        k.p[u * M + m] = k.z[u * M + m] + beta * k.p[u * M + m];
    rz = rzn;
    rr = block_sum(rrn, red);  // also publishes p for the next matvec
  }
  return it;
}

__global__ void pcg_lm_kernel(Ctx k, float* __restrict__ out, int L,
                              float lam0, int iters, int cg_iters,
                              float cg_tol, float sq_min_delta) {
  __shared__ float red[33];
  const int M = k.M;
  const float cost0 = graph_cost(k, k.P, red);
  float lam = lam0, laminc = 2.f, cost = cost0, good = 0.f;
  int it = 0, cg_total = 0;
  bool done = false;
  while (it < iters && !done) {
    normal_eq(k, lam);
    cg_total += pcg(k, cg_iters, cg_tol, red);
    float sq = 0.f;
    for (int m = threadIdx.x; m < M; m += blockDim.x)
      for (int u = 0; u < 3; ++u) {
        const float dl = k.x[u * M + m];
        sq += dl * dl;
        const float v = k.P[u * M + m] + dl;
        k.C[u * M + m] = u == 2 ? wrap(v) : v;
      }
    sq = block_sum(sq, red);  // also publishes C
    const bool converged = sq < sq_min_delta;
    const float new_cost = graph_cost(k, k.C, red);
    const bool accept = new_cost < cost && !converged;
    if (accept) {
      for (int m = threadIdx.x; m < M; m += blockDim.x)
        for (int u = 0; u < 3; ++u) k.P[u * M + m] = k.C[u * M + m];
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
  // packed (8, L) result, L = max(M, 4) so the stats lanes always exist
  for (int m = threadIdx.x; m < L; m += blockDim.x) {
    for (int u = 0; u < 3; ++u) out[u * L + m] = m < M ? k.P[u * M + m] : 0.f;
    float s = 0.f;
    if (m == 0) s = cost0;
    if (m == 1) s = cost;
    if (m == 2) s = good;
    if (m == 3) s = (float)it;
    out[3 * L + m] = s;
    // row 4, lane 0: the PCG iterations run over the whole solve (the
    // work this solve's data needed; the plain version leaves it 0)
    out[4 * L + m] = m == 0 ? (float)cg_total : 0.f;
    for (int u = 5; u < 8; ++u) out[u * L + m] = 0.f;
  }
}

}  // namespace

extern "C" int pcg_lm_launch(const void* pT, const void* ei, const void* ej,
                             const void* meansT, const void* W6,
                             const void* fm, const void* row_ptr,
                             const void* inc, void* out, int L,
                             void* scratch, float lam0, int M, int E,
                             int iters,
                             int cg_iters, float cg_tol, float sq_min_delta,
                             void* stream) {
  Ctx k;
  k.M = M;
  k.E = E;
  k.meansT = (const float*)meansT;
  k.W6 = (const float*)W6;
  k.fm = (const float*)fm;
  k.ei = (const int*)ei;
  k.ej = (const int*)ej;
  k.row_ptr = (const int*)row_ptr;
  k.inc = (const int*)inc;
  float* s = (float*)scratch;
  const size_t m3 = 3 * (size_t)M;
  k.P = s;
  k.C = k.P + m3;
  k.d6 = k.C + m3;
  k.mi6 = k.d6 + 2 * m3;
  k.b3 = k.mi6 + 2 * m3;
  k.x = k.b3 + m3;
  k.r = k.x + m3;
  k.z = k.r + m3;
  k.p = k.z + m3;
  k.Ap = k.p + m3;
  float* ed = k.Ap + m3;  // 36 M floats above, 33 E below
  k.Hij9 = ed;
  k.Hii6 = k.Hij9 + 9 * (size_t)E;
  k.Hjj6 = k.Hii6 + 6 * (size_t)E;
  k.bi3 = k.Hjj6 + 6 * (size_t)E;
  k.bj3 = k.bi3 + 3 * (size_t)E;
  k.uv6 = k.bj3 + 3 * (size_t)E;
  cudaError_t e = cudaMemcpyAsync(k.P, pT, m3 * sizeof(float),
                                  cudaMemcpyDeviceToDevice,
                                  (cudaStream_t)stream);
  if (e != cudaSuccess) return (int)e;
  pcg_lm_kernel<<<1, 1024, 0, (cudaStream_t)stream>>>(
      k, (float*)out, L, lam0, iters, cg_iters, cg_tol, sq_min_delta);
  return (int)cudaGetLastError();
}
