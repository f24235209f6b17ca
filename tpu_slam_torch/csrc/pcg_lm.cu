// The whole doSPA Levenberg-Marquardt solve with an inner block-Jacobi
// preconditioned conjugate-gradient (PCG) step, in one launch.
//
// Replaces: tpu_slam/solver/pallas_lm.py::fused_lm_solve (Pallas kernel
// _make_kernel).
//
// What bounds it on the H100: latency and one SM's shared-memory rate. The
// offline mission's graph (~1k nodes, ~1.2k edges) is ~100 KB; one PCG
// iteration is a few 10k FLOPs, but up to cg_iters x iters of them run back
// to back, each a chain of cluster-wide dependencies (the matvec needs every
// neighbour's p, the step needs p^T A p, the next direction needs r.z), and
// on one SM the matvec's gathers alone took ~3 us an iteration.
//
// Design: one thread-block cluster of up to 8 blocks runs the whole solve,
// so the LM accept/reject loop never leaves the kernel
// (solver/pcg_lm.py::launch_geometry sizes it).
// - Nodes are cut into power-of-two ranges of S, one range a block; each
//   node is a thread's. A block's CG hot set lives in its dynamic shared
//   memory where it fits: x, r, z (its 4th lane the free flag), two p
//   buffers, Ap, the damped diagonal blocks and their inverses (the
//   preconditioner), and for each incidence of its nodes (the host's CSR
//   list) the other node and the edge's H_ij oriented for this end (H_ij
//   at node i, H_ij^T at node j). Node vectors are float4, symmetric 3x3
//   blocks float4 + float2, H float4 x 2 + float. A neighbour in another
//   block is read through distributed shared memory. Graphs whose ranges
//   do not fit take the same code with those arrays in device memory (the
//   SMEM template flag), read through L2.
// - The matvec is node-centric: node m sums D_m p_m and, in CSR order, its
//   incidences' H p_other. It also forms the new direction p = z + beta p
//   for itself and, on the fly, for each neighbour it reads (the same
//   fmaf, so the same bits as the neighbour's own), writing its own into
//   the other p buffer, and accumulates p^T A p.
// - Reductions: warp shuffles, one partial per warp, one block barrier,
//   warp 0 adding the partials by a fixed butterfly and pushing the
//   block's total into every block's shared memory with a remote mbarrier
//   arrival; each block waits on its own mbarrier and adds the totals in
//   rank order (no cluster-wide barrier). r.z and r.r are reduced
//   together, so a PCG iteration is two such reductions; p^T A p, after
//   which nothing another block wrote is read before the next, pushes its
//   totals by st.async instead and pays no release fence.
// - The per-LM-iteration assembly runs a thread per edge over the cluster
//   (blocks in device memory; H into the two ends' incidence slots), then
//   a thread per node. Poses and the candidate live in device memory.
// - Restarted CG (restarts > 1, the reference's cg_solve(restarts=)): after
//   each run of at most cg_iters iterations the true residual r = -b - A x
//   is recomputed (one more matvec, through the same neighbour reads as
//   A p) and a fresh Krylov space starts from p = z = M^-1 r; the stopping
//   threshold stays that of the first run. One run is cg_run, the loop of
//   the kernel without restarts; the kernel is templated on whether it
//   restarts, so a solve with restarts = 1 runs that code alone.
// Every sum has a fixed order and no atomics are used. PCG stops as soon as
// ||r||^2 <= cg_tol ||b||^2, which is where the reference's masked
// iterations stop changing anything. The TPU kernel's (E, M) one-hot
// gather/scatter matmuls become direct gathers and per-node sums.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>

#include "cluster.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int MAX_THREADS = 512;  // threads a block (solver/pcg_lm.py)
constexpr int MAX_CLUSTER = 8;    // portable cluster size

struct Ctx {
  int M, E, logS, qmax;
  const float* meansT;  // (3, E)
  const float* W6;      // (6, E) information upper triangle, mask-weighted
  const float* fm;      // (M,) 1 = free
  const int* ei;        // (E,)
  const int* ej;        // (E,)
  const int* row_ptr;   // (M + 1,) CSR of each node's incidences
  const int* pos;       // (2E,) incidence of edge e's end role: 2e + role
  float* P;             // (3, M) current poses
  float* C;             // (3, M) candidate poses
  float* b3;            // (3, M)
  float* Hii6;          // (6, E)
  float* Hjj6;          // (6, E)
  float* bi3;           // (3, E)
  float* bj3;           // (3, E)
  // the hot set, this block's part: shared memory, or device memory
  // offset to the block's first node (node arrays) and the whole graph's
  // (incidence arrays, indexed by the global CSR)
  float4* x;
  float4* p;            // the current direction
  float4* pn;           // the next one
  float4* z;            // its 4th lane: the free flag
  float4* r;
  float4* Ap;
  float4* d4;           // damped, gauge-fixed diagonal blocks:
  float2* d2;           //   (d00, d01, d02, d11), (d12, d22)
  float4* m4;           // their inverses (preconditioner), likewise
  float2* m2;
  float4* ha;           // per incidence: H oriented for this end,
  float4* hb;           //   (H00, H01, H02, H10), (H11, H12, H20, H21),
  float* hc;            //   H22
  const int2* inc;      // per incidence: (2 * edge + role, the other node)
  const int* rp;        // (S + 1,) this block's nodes' incidence ranges
};

// Words of a block's hot set in shared memory (solver/pcg_lm.py::
// hot_set_bytes): x, p, pn, z, r, Ap, d4, m4 (4S each), d2, m2 (2S each),
// ha, hb (4 qmax each), inc (2 qmax), hc (qmax), rp (S + 1).
__host__ __device__ constexpr size_t hot_words(size_t S, size_t qmax) {
  return 37 * S + 11 * qmax + 1;
}

struct Part {  // this block's share of the graph
  int rank, nb, S, logS, o0, nloc, gtid, gthreads;
};

__device__ __forceinline__ float wrap(float th) {
  return th - 6.283185307179586f *
                  floorf((th + 3.141592653589793f) / 6.283185307179586f);
}

__device__ __forceinline__ float ldg(const float* p) { return __ldcg(p); }

// A node-array element of node o (any block's): through distributed
// shared memory, or through L2 from device memory.
template <bool SMEM, class T>
__device__ __forceinline__ T node_get(T* a, int o, const Part& pt) {
  if constexpr (SMEM) {
    const int b = o >> pt.logS, lo = o & (pt.S - 1);
    if (b == pt.rank) return a[lo];
    return *cg::this_cluster().map_shared_rank(a + lo, b);
  } else {
    return __ldcg(a + (o - pt.o0));
  }
}

// An incidence-array element written by another thread this phase's
// predecessor (shared memory as is, device memory through L2).
template <bool SMEM, class T>
__device__ __forceinline__ T hot_get(const T* a) {
  if constexpr (SMEM) return *a;
  return __ldcg(a);
}

// Shared-memory addresses for the cluster reductions' PTX.
__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// The same variable in block `rank`'s shared memory (shared::cluster).
__device__ __forceinline__ unsigned map_u32(unsigned a, unsigned rank) {
  unsigned r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
               : "=r"(r) : "r"(a), "r"(rank));
  return r;
}

__device__ __forceinline__ bool try_wait(unsigned bar, unsigned phase) {
  unsigned ok;
  asm volatile(
      "{\n .reg .pred p;\n"
      " mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], %2;\n"
      " selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(ok) : "r"(bar), "r"(phase) : "memory");
  return ok != 0;
}

struct Sums {  // the cluster reductions' buffers, in shared memory
  float2* red;               // 2 x 32 warp partials
  float2* slots;             // 2 x MAX_CLUSTER block totals
  unsigned long long* bars;  // 2 mbarriers, one arrival a block each
  int n;                     // reductions so far
  float2* aslots;            // cluster_sum_async's: 2 x MAX_CLUSTER totals,
  unsigned long long* abars; //   2 mbarriers (one local arrival, tx bytes)
  int an;
};

// Cluster-wide sums of (a, b) in a fixed order; every thread gets both.
// The warps' partials meet in shared memory; warp 0 adds them by a fixed
// butterfly, and its lane r stores the block's total into block r's slot
// for this block and arrives on block r's mbarrier (release, cluster
// scope). Each block waits on its own mbarrier (acquire) and adds its
// slots in rank order: no cluster-wide barrier. Partials, slots and
// mbarriers alternate between two sets, so a set is reused only after
// every block has left its previous use. Also publishes this thread's
// earlier writes to the cluster (device-memory ones fenced first in the
// device-memory variant).
template <bool SMEM>
__device__ float2 cluster_sum2(float a, float b, Sums& sm) {
  if constexpr (!SMEM) __threadfence();
  for (int o = 16; o > 0; o >>= 1) {
    a += __shfl_xor_sync(0xffffffffu, a, o);
    b += __shfl_xor_sync(0xffffffffu, b, o);
  }
  const int set = sm.n & 1;
  const unsigned phase = (sm.n >> 1) & 1;
  ++sm.n;
  float2* buf = sm.red + 32 * set;
  float2* slot = sm.slots + MAX_CLUSTER * set;
  const unsigned bar = smem_u32(sm.bars + set);
  const int lane = threadIdx.x & 31;
  if (lane == 0) buf[threadIdx.x >> 5] = make_float2(a, b);
  __syncthreads();
  cg::cluster_group cl = cg::this_cluster();
  const int nb = (int)cl.num_blocks();
  if (threadIdx.x < 32) {
    float2 s = lane < (int)(blockDim.x >> 5) ? buf[lane] : make_float2(0.f, 0.f);
    for (int o = 16; o > 0; o >>= 1) {
      s.x += __shfl_xor_sync(0xffffffffu, s.x, o);
      s.y += __shfl_xor_sync(0xffffffffu, s.y, o);
    }
    if (lane < nb) {
      const unsigned dst = map_u32(smem_u32(slot + cl.block_rank()), lane);
      asm volatile("st.shared::cluster.v2.f32 [%0], {%1, %2};"
                   :: "r"(dst), "f"(s.x), "f"(s.y) : "memory");
      asm volatile(
          "mbarrier.arrive.release.cluster.shared::cluster.b64 _, [%0];"
          :: "r"(map_u32(bar, lane)) : "memory");
    }
  }
  while (!try_wait(bar, phase)) {
  }
  float2 t = make_float2(0.f, 0.f);
  for (int r = 0; r < nb; ++r) {
    t.x += slot[r].x;
    t.y += slot[r].y;
  }
  return t;
}

// The same sum without publishing anything else: each block's total goes
// into every block's slot by st.async, which signals the receiver's
// mbarrier with its bytes, and each block expects nb totals' bytes; no
// release fence is paid. For a sum after which no thread reads what
// another block wrote since the last publishing reduction (p^T A p: the
// new directions are read only after the r.z reduction).
__device__ float cluster_sum_async(float a, float2* red, Sums& sm) {
  for (int o = 16; o > 0; o >>= 1) a += __shfl_xor_sync(0xffffffffu, a, o);
  const int set = sm.an & 1;
  const unsigned phase = (sm.an >> 1) & 1;
  ++sm.an;
  float2* buf = red + 32 * set;
  float2* slot = sm.aslots + MAX_CLUSTER * set;
  const unsigned bar = smem_u32(sm.abars + set);
  const int lane = threadIdx.x & 31;
  cg::cluster_group cl = cg::this_cluster();
  const int nb = (int)cl.num_blocks();
  if (threadIdx.x == 0)
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
                 :: "r"(bar), "r"(nb * 8) : "memory");
  if (lane == 0) buf[threadIdx.x >> 5] = make_float2(a, 0.f);
  __syncthreads();
  if (threadIdx.x < 32) {
    float s = lane < (int)(blockDim.x >> 5) ? buf[lane].x : 0.f;
    for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
    if (lane < nb) {
      const unsigned dst = map_u32(smem_u32(slot + cl.block_rank()), lane);
      asm volatile(
          "st.async.shared::cluster.mbarrier::complete_tx::bytes.v2.f32 "
          "[%0], {%1, %2}, [%3];"
          :: "r"(dst), "f"(s), "f"(0.f), "r"(map_u32(bar, lane)) : "memory");
    }
  }
  while (!try_wait(bar, phase)) {
  }
  float t = 0.f;
  for (int r = 0; r < nb; ++r) t += slot[r].x;
  return t;
}

struct Terms {
  float c, s, drx, dry, r[3];
};

__device__ __forceinline__ Terms edge_terms(const Ctx& k, const float* P,
                                            int e) {
  const int i = k.ei[e], j = k.ej[e];
  const int M = k.M, E = k.E;
  const float ti = ldg(P + 2 * M + i);
  Terms t;
  t.c = cosf(ti);
  t.s = sinf(ti);
  const float dx = ldg(P + j) - ldg(P + i), dy = ldg(P + M + j) - ldg(P + M + i);
  t.r[0] = t.c * dx + t.s * dy - k.meansT[e];
  t.r[1] = -t.s * dx + t.c * dy - k.meansT[E + e];
  t.r[2] = wrap(ldg(P + 2 * M + j) - ti - k.meansT[2 * E + e]);
  t.drx = -t.s * dx + t.c * dy;
  t.dry = -t.c * dx - t.s * dy;
  return t;
}

template <bool SMEM>
__device__ float graph_cost(const Ctx& k, const float* P, const Part& pt,
                            Sums& sm) {
  float acc = 0.f;
  for (int e = pt.gtid; e < k.E; e += pt.gthreads) {
    const Terms t = edge_terms(k, P, e);
    const float* w = k.W6 + e;
    const int E = k.E;
    const float r0 = t.r[0], r1 = t.r[1], r2 = t.r[2];
    acc += w[0] * r0 * r0 + 2.f * w[E] * r0 * r1 + 2.f * w[2 * E] * r0 * r2 +
           w[3 * E] * r1 * r1 + 2.f * w[4 * E] * r1 * r2 + w[5 * E] * r2 * r2;
  }
  return cluster_sum2<SMEM>(acc, 0.f, sm).x;
}

// index of (u, v) in the 6-entry upper triangle
__device__ __forceinline__ int up6(int u, int v) {
  const int a = u < v ? u : v, b = u < v ? v : u;
  return a == 0 ? b : (a == 1 ? 2 + b : 5);
}

// Store H (row-major 3x3) at incidence q of node `node` (any block's).
template <bool SMEM>
__device__ __forceinline__ void put_h(const Ctx& k, const Part& pt, int node,
                                      int q, const float (&H)[3][3]) {
  float4* ha = k.ha;
  float4* hb = k.hb;
  float* hc = k.hc;
  if constexpr (SMEM) {
    const int b = node >> pt.logS;
    q -= k.row_ptr[min(b << pt.logS, k.M)];
    if (b != pt.rank) {
      cg::cluster_group cl = cg::this_cluster();
      ha = cl.map_shared_rank(ha, b);
      hb = cl.map_shared_rank(hb, b);
      hc = cl.map_shared_rank(hc, b);
    }
  }
  ha[q] = make_float4(H[0][0], H[0][1], H[0][2], H[1][0]);
  hb[q] = make_float4(H[1][1], H[1][2], H[2][0], H[2][1]);
  hc[q] = H[2][2];
}

// Normal equations at P, damped by lam and gauge-fixed: a thread per edge
// over the cluster, then a thread per own node. Fills the diagonal blocks
// and their inverses, b3 and each incidence's H.
template <bool SMEM>
__device__ void normal_eq(const Ctx& k, const Part& pt, float lam) {
  const int E = k.E, M = k.M;
  for (int e = pt.gtid; e < E; e += pt.gthreads) {
    const Terms t = edge_terms(k, k.P, e);
    const float Ji[3][3] = {{-t.c, -t.s, t.drx}, {t.s, -t.c, t.dry},
                            {0.f, 0.f, -1.f}};
    const float Jj[3][3] = {{t.c, t.s, 0.f}, {-t.s, t.c, 0.f},
                            {0.f, 0.f, 1.f}};
    const float* w = k.W6 + e;
    const float O[3][3] = {{w[0], w[E], w[2 * E]},
                           {w[E], w[3 * E], w[4 * E]},
                           {w[2 * E], w[4 * E], w[5 * E]}};
    float IW[3][3], JW[3][3], H[3][3], HT[3][3];  // J^T Omega, H_ij
    for (int u = 0; u < 3; ++u)
      for (int m = 0; m < 3; ++m) {
        IW[u][m] = Ji[0][u] * O[0][m] + Ji[1][u] * O[1][m] + Ji[2][u] * O[2][m];
        JW[u][m] = Jj[0][u] * O[0][m] + Jj[1][u] * O[1][m] + Jj[2][u] * O[2][m];
      }
    for (int u = 0; u < 3; ++u) {
      for (int v = 0; v < 3; ++v) {
        H[u][v] = IW[u][0] * Jj[0][v] + IW[u][1] * Jj[1][v] + IW[u][2] * Jj[2][v];
        HT[v][u] = H[u][v];
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
    put_h<SMEM>(k, pt, k.ei[e], k.pos[2 * e], H);       // H_ij p_j at i
    put_h<SMEM>(k, pt, k.ej[e], k.pos[2 * e + 1], HT);  // H_ij^T p_i at j
  }
  __threadfence();
  cg::this_cluster().sync();
  const float one_lam = 1.f + lam;
  for (int l = threadIdx.x; l < pt.nloc; l += blockDim.x) {
    const int m = pt.o0 + l;
    float h[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f}, b[3] = {0.f, 0.f, 0.f};
    for (int q = k.rp[l]; q < k.rp[l + 1]; ++q) {
      const int code = k.inc[q].x, e = code >> 1;
      const float* hs = (code & 1) ? k.Hjj6 : k.Hii6;
      const float* bs = (code & 1) ? k.bj3 : k.bi3;
      for (int u = 0; u < 6; ++u) h[u] += ldg(hs + u * E + e);
      for (int u = 0; u < 3; ++u) b[u] += ldg(bs + u * E + e);
    }
    const float f = k.fm[m], nf = 1.f - f;
    const float d00 = ((h[0] + 1e-12f) * one_lam) * f + nf;
    const float d11 = ((h[3] + 1e-12f) * one_lam) * f + nf;
    const float d22 = ((h[5] + 1e-12f) * one_lam) * f + nf;
    const float d01 = h[1] * f, d02 = h[2] * f, d12 = h[4] * f;
    k.d4[l] = make_float4(d00, d01, d02, d11);
    k.d2[l] = make_float2(d12, d22);
    // block-Jacobi inverse by cofactors
    const float c00 = d11 * d22 - d12 * d12;
    const float c01 = d02 * d12 - d01 * d22;
    const float c02 = d01 * d12 - d02 * d11;
    const float det = d00 * c00 + d01 * c01 + d02 * c02;
    const float inv_det = 1.f / (fabsf(det) > 1e-30f ? det : 1.f);
    k.m4[l] = make_float4(c00 * inv_det, c01 * inv_det, c02 * inv_det,
                          (d00 * d22 - d02 * d02) * inv_det);
    k.m2[l] = make_float2((d02 * d01 - d00 * d12) * inv_det,
                          (d00 * d11 - d01 * d01) * inv_det);
    for (int u = 0; u < 3; ++u) k.b3[u * M + m] = b[u];
  }
}

// y = S v for the symmetric 3x3 S = (a.x a.y a.z; . a.w b.x; . . b.y)
__device__ __forceinline__ float3 sym3(float4 a, float2 b, float3 v) {
  return make_float3(a.x * v.x + a.y * v.y + a.z * v.z,
                     a.y * v.x + a.w * v.y + b.x * v.z,
                     a.z * v.x + b.x * v.y + b.y * v.z);
}

// The direction of a node for this iteration, p = z + beta p_prev: the
// one expression every reader of the node evaluates, so all get its bits.
__device__ __forceinline__ float3 direction(float4 p, float4 z, float beta) {
  return make_float3(__fmaf_rn(beta, p.x, z.x), __fmaf_rn(beta, p.y, z.y),
                     __fmaf_rn(beta, p.z, z.z));
}

// r <- -b - A x and z <- M^-1 r for this block's nodes (x masked as the
// matvec masks it), p <- 0 so that the next direction is z; returns the
// cluster sums (r.z, r.r). A restart of restarted CG.
template <bool SMEM>
__device__ float2 true_residual(Ctx& k, const Part& pt, Sums& sm) {
  const int M = k.M;
  float rz = 0.f, rr = 0.f;
  for (int l = threadIdx.x; l < pt.nloc; l += blockDim.x) {
    const int m = pt.o0 + l;
    const float4 zm = k.z[l], xl = k.x[l];
    const float f = zm.w, nf = 1.f - f;
    const float3 xm = make_float3(xl.x * f, xl.y * f, xl.z * f);
    float3 y = sym3(k.d4[l], k.d2[l], xm);
    const int q1 = k.rp[l + 1];
    for (int q = k.rp[l]; q < q1; ++q) {
      const int o = k.inc[q].y;
      const float fo = node_get<SMEM>(k.z, o, pt).w;
      const float4 x4 = node_get<SMEM>(k.x, o, pt);
      const float3 xo = make_float3(x4.x * fo, x4.y * fo, x4.z * fo);
      const float4 a = hot_get<SMEM>(k.ha + q), b = hot_get<SMEM>(k.hb + q);
      const float c = hot_get<SMEM>(k.hc + q);
      y.x += a.x * xo.x + a.y * xo.y + a.z * xo.z;
      y.y += a.w * xo.x + b.x * xo.y + b.y * xo.z;
      y.z += b.z * xo.x + b.w * xo.y + c * xo.z;
    }
    const float3 rv = make_float3(
        -k.b3[m] * f - (y.x * f + xm.x * nf),
        -k.b3[M + m] * f - (y.y * f + xm.y * nf),
        -k.b3[2 * M + m] * f - (y.z * f + xm.z * nf));
    const float3 zv = sym3(k.m4[l], k.m2[l], rv);
    k.r[l] = make_float4(rv.x, rv.y, rv.z, 0.f);
    k.z[l] = make_float4(zv.x, zv.y, zv.z, f);
    k.p[l] = make_float4(0.f, 0.f, 0.f, 0.f);
    rz += rv.x * zv.x + rv.y * zv.y + rv.z * zv.z;
    rr += rv.x * rv.x + rv.y * rv.y + rv.z * rv.z;
  }
  return cluster_sum2<SMEM>(rz, rr, sm);
}

// One run of at most cg_iters PCG iterations from the state in k (r, z,
// x, and p = 0 so that the first direction is z), while ||r||^2 > stop2;
// rr and rz carry r.r and r.z in and out. Returns the iterations run.
template <bool SMEM>
__device__ __forceinline__ int cg_run(Ctx& k, const Part& pt, int cg_iters,
                                      float stop2, float& rr, float& rz,
                                      Sums& sm) {
  float beta = 0.f;
  int it = 0;
  for (; it < cg_iters && rr > stop2; ++it) {
    // Ap = H p on the gauge-fixed system (cg_matvec semantics), with this
    // iteration's p formed here, and p^T A p
    float pap = 0.f;
    for (int l = threadIdx.x; l < pt.nloc; l += blockDim.x) {
      const float4 zm = k.z[l];
      const float f = zm.w;
      const float3 pm = direction(k.p[l], zm, beta);
      k.pn[l] = make_float4(pm.x, pm.y, pm.z, 0.f);
      const float3 xm = make_float3(pm.x * f, pm.y * f, pm.z * f);
      float3 y = sym3(k.d4[l], k.d2[l], xm);
      const int q1 = k.rp[l + 1];
      for (int q = k.rp[l]; q < q1; ++q) {
        const int o = k.inc[q].y;
        const float4 zo = node_get<SMEM>(k.z, o, pt);
        const float3 po = direction(node_get<SMEM>(k.p, o, pt), zo, beta);
        const float3 xo = make_float3(po.x * zo.w, po.y * zo.w, po.z * zo.w);
        const float4 a = hot_get<SMEM>(k.ha + q), b = hot_get<SMEM>(k.hb + q);
        const float c = hot_get<SMEM>(k.hc + q);
        // H = (a.x a.y a.z; a.w b.x b.y; b.z b.w c), oriented for node m
        y.x += a.x * xo.x + a.y * xo.y + a.z * xo.z;
        y.y += a.w * xo.x + b.x * xo.y + b.y * xo.z;
        y.z += b.z * xo.x + b.w * xo.y + c * xo.z;
      }
      const float nf = 1.f - f;
      const float4 ap = make_float4(y.x * f + xm.x * nf, y.y * f + xm.y * nf,
                                    y.z * f + xm.z * nf, 0.f);
      k.Ap[l] = ap;
      pap += pm.x * ap.x + pm.y * ap.y + pm.z * ap.z;
    }
    pap = cluster_sum_async(pap, sm.red + 64, sm);
    float4* tmp = k.p;  // this iteration's p is now the current one
    k.p = k.pn;
    k.pn = tmp;
    const float alpha = rz / (pap != 0.f ? pap : 1.f);
    float rzn = 0.f, rrn = 0.f;
    for (int l = threadIdx.x; l < pt.nloc; l += blockDim.x) {
      const float4 pm = k.p[l], ap = k.Ap[l], r = k.r[l];
      float4 x = k.x[l];
      x.x += alpha * pm.x;
      x.y += alpha * pm.y;
      x.z += alpha * pm.z;
      k.x[l] = x;
      const float3 rv = make_float3(r.x - alpha * ap.x, r.y - alpha * ap.y,
                                    r.z - alpha * ap.z);
      const float3 zv = sym3(k.m4[l], k.m2[l], rv);
      k.r[l] = make_float4(rv.x, rv.y, rv.z, 0.f);
      k.z[l] = make_float4(zv.x, zv.y, zv.z, k.z[l].w);
      rrn += rv.x * rv.x + rv.y * rv.y + rv.z * rv.z;
      rzn += rv.x * zv.x + rv.y * zv.y + rv.z * zv.z;
    }
    const float2 s = cluster_sum2<SMEM>(rzn, rrn, sm);
    beta = s.x / (rz != 0.f ? rz : 1.f);
    rz = s.x;
    rr = s.y;
  }
  return it;
}

// x <- PCG solution of H x = -b (block-Jacobi preconditioner), in
// `restarts` runs of at most cg_iters iterations when RESTART (else one,
// the code of a kernel without restarts); returns the number of
// iterations run.
template <bool SMEM, bool RESTART>
__device__ int pcg(Ctx& k, const Part& pt, int cg_iters, float cg_tol,
                   int restarts, Sums& sm) {
  const int M = k.M;
  float bb2 = 0.f, rz0 = 0.f;
  for (int l = threadIdx.x; l < pt.nloc; l += blockDim.x) {
    const int m = pt.o0 + l;
    const float f = k.fm[m];
    const float3 rv = make_float3(-k.b3[m] * f, -k.b3[M + m] * f,
                                  -k.b3[2 * M + m] * f);
    const float3 zv = sym3(k.m4[l], k.m2[l], rv);
    k.x[l] = make_float4(0.f, 0.f, 0.f, 0.f);
    k.r[l] = make_float4(rv.x, rv.y, rv.z, 0.f);
    k.p[l] = make_float4(0.f, 0.f, 0.f, 0.f);  // so the first direction is z
    k.z[l] = make_float4(zv.x, zv.y, zv.z, f);
    bb2 += rv.x * rv.x + rv.y * rv.y + rv.z * rv.z;
    rz0 += rv.x * zv.x + rv.y * zv.y + rv.z * zv.z;
  }
  const float2 s0 = cluster_sum2<SMEM>(bb2, rz0, sm);
  const float stop2 = cg_tol * s0.x;
  float rr = s0.x;  // r starts at -b
  float rz = s0.y;
  int it = cg_run<SMEM>(k, pt, cg_iters, stop2, rr, rz, sm);
  if constexpr (RESTART) {
    for (int run = 1; run < restarts; ++run) {
      // the true residual of x, a fresh Krylov space
      const float2 s = true_residual<SMEM>(k, pt, sm);
      rz = s.x;
      rr = s.y;
      it += cg_run<SMEM>(k, pt, cg_iters, stop2, rr, rz, sm);
    }
  }
  return it;
}

template <bool SMEM, bool RESTART>
__global__ void __launch_bounds__(MAX_THREADS, 1)
    pcg_lm_kernel(Ctx k, float* __restrict__ out, int L, float lam0, int iters,
                  int cg_iters, float cg_tol, float sq_min_delta,
                  int restarts) {
  extern __shared__ float4 dyn4[];
  __shared__ float2 red[128];  // cluster_sum2's 2 x 32, then the async's
  __shared__ float2 slots[2 * MAX_CLUSTER];
  __shared__ float2 aslots[2 * MAX_CLUSTER];
  __shared__ unsigned long long bars[2];
  __shared__ unsigned long long abars[2];
  cg::cluster_group cl = cg::this_cluster();
  Part pt;
  pt.rank = cl.block_rank();
  pt.nb = cl.num_blocks();
  pt.logS = k.logS;
  pt.S = 1 << k.logS;
  pt.o0 = pt.rank * pt.S;
  pt.nloc = max(0, min(pt.S, k.M - pt.o0));
  pt.gtid = pt.rank * blockDim.x + threadIdx.x;
  pt.gthreads = pt.nb * blockDim.x;
  Sums sm = {red, slots, bars, 0, aslots, abars, 0};
  if (threadIdx.x == 0) {
    for (int i = 0; i < 2; ++i) {
      asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;"
                   :: "r"(smem_u32(bars + i)), "r"(pt.nb) : "memory");
      asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;"
                   :: "r"(smem_u32(abars + i)), "r"(1) : "memory");
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  const int M = k.M, S = pt.S;
  if constexpr (SMEM) {  // carve this block's hot set and copy its lists in
    float4* v = dyn4;
    k.x = v;
    k.p = k.x + S;
    k.pn = k.p + S;
    k.z = k.pn + S;
    k.r = k.z + S;
    k.Ap = k.r + S;
    k.d4 = k.Ap + S;
    k.m4 = k.d4 + S;
    k.d2 = reinterpret_cast<float2*>(k.m4 + S);
    k.m2 = k.d2 + S;
    k.ha = reinterpret_cast<float4*>(k.m2 + S);
    k.hb = k.ha + k.qmax;
    int2* inc = reinterpret_cast<int2*>(k.hb + k.qmax);
    k.hc = reinterpret_cast<float*>(inc + k.qmax);
    int* rp = reinterpret_cast<int*>(k.hc + k.qmax);
    const int q0 = k.row_ptr[min(pt.o0, M)];
    const int nq = k.row_ptr[min(pt.o0 + S, M)] - q0;
    for (int q = threadIdx.x; q < nq; q += blockDim.x) inc[q] = k.inc[q0 + q];
    for (int l = threadIdx.x; l <= pt.nloc; l += blockDim.x)
      rp[l] = k.row_ptr[pt.o0 + l] - q0;
    k.inc = inc;
    k.rp = rp;
  } else {  // this block's nodes in the device-memory arrays
    k.x += pt.o0;
    k.p += pt.o0;
    k.pn += pt.o0;
    k.z += pt.o0;
    k.r += pt.o0;
    k.Ap += pt.o0;
    k.d4 += pt.o0;
    k.m4 += pt.o0;
    k.d2 += pt.o0;
    k.m2 += pt.o0;
    k.rp = k.row_ptr + min(pt.o0, M);
  }
  cl.sync();  // every block has started (and its mbarriers are set up)
  const float cost0 = graph_cost<SMEM>(k, k.P, pt, sm);
  float lam = lam0, laminc = 2.f, cost = cost0, good = 0.f;
  int it = 0, cg_total = 0;
  bool done = false;
  while (it < iters && !done) {
    normal_eq<SMEM>(k, pt, lam);
    cg_total += pcg<SMEM, RESTART>(k, pt, cg_iters, cg_tol, restarts, sm);
    float sq = 0.f;
    for (int l = threadIdx.x; l < pt.nloc; l += blockDim.x) {
      const int m = pt.o0 + l;
      const float4 x = k.x[l];
      const float dl[3] = {x.x, x.y, x.z};
      for (int u = 0; u < 3; ++u) {
        sq += dl[u] * dl[u];
        const float v = k.P[u * M + m] + dl[u];
        k.C[u * M + m] = u == 2 ? wrap(v) : v;
      }
    }
    __threadfence();  // C is in device memory in both variants
    sq = cluster_sum2<SMEM>(sq, 0.f, sm).x;  // publishes C
    const bool converged = sq < sq_min_delta;
    const float new_cost = graph_cost<SMEM>(k, k.C, pt, sm);
    if (new_cost < cost && !converged) {  // accept: C becomes P
      float* tmp = k.P;
      k.P = k.C;
      k.C = tmp;
      cost = new_cost;
      lam = lam * 0.5f;
      good += 1.f;
    } else {
      lam = lam * laminc;
      laminc = laminc * 2.f;
    }
    ++it;
    done = converged;
  }
  // packed (8, L) result, L = max(M, 4) so the stats lanes always exist:
  // each block its nodes' lanes, block 0 also the lanes past the last node
  const int extra = pt.rank == 0 ? L - M : 0;
  for (int l = threadIdx.x; l < pt.nloc + extra; l += blockDim.x) {
    const int m = l < pt.nloc ? pt.o0 + l : M + (l - pt.nloc);
    for (int u = 0; u < 3; ++u) out[u * L + m] = m < M ? k.P[u * M + m] : 0.f;
    float s = 0.f;
    if (m == 0) s = cost0;
    if (m == 1) s = cost;
    if (m == 2) s = good;
    if (m == 3) s = (float)it;
    out[3 * L + m] = s;
    // row 4, lane 0: the PCG iterations run over the whole solve, every
    // restart's (the work this solve's data needed; the plain version
    // counts the same)
    out[4 * L + m] = m == 0 ? (float)cg_total : 0.f;
    for (int u = 5; u < 8; ++u) out[u * L + m] = 0.f;
  }
  cl.sync();  // no block leaves while another may read its shared memory
}

}  // namespace

// One cluster of `blocks` blocks; block b owns nodes [b S, (b + 1) S),
// S = 2^logS, with min(S, MAX_THREADS) threads. inc is (2E, 2) int32: each
// incidence's 2 * edge + role and the edge's other node, in CSR order
// (row_ptr); pos (2E,) the incidence of each edge end. smem = 0 runs the
// device-memory variant; otherwise each block's hot-set bytes (at least 4
// hot_words(S, qmax), qmax the most incidences a block holds). restarts
// (>= 1) runs of at most cg_iters PCG iterations each LM step. Returns a
// cudaError_t: non-zero when the arguments are out of range or the card
// refuses the cluster.
extern "C" int pcg_lm_launch(const void* pT, const void* ei, const void* ej,
                             const void* meansT, const void* W6,
                             const void* fm, const void* row_ptr,
                             const void* inc, const void* pos, void* out,
                             int L, void* scratch, float lam0, int M, int E,
                             int iters, int cg_iters, float cg_tol,
                             float sq_min_delta, int blocks, int logS,
                             int qmax, int smem, int restarts,
                             void* stream) {
  if (M < 1 || E < 1 || restarts < 1 || blocks < 1 || blocks > MAX_CLUSTER ||
      logS < 0 ||
      logS > 20 || ((size_t)blocks << logS) < (size_t)M || qmax < 0 ||
      smem < 0 ||
      (smem > 0 && (size_t)smem < 4 * hot_words((size_t)1 << logS, qmax)))
    return (int)cudaErrorInvalidValue;
  Ctx k;
  k.M = M;
  k.E = E;
  k.logS = logS;
  k.qmax = qmax;
  k.meansT = (const float*)meansT;
  k.W6 = (const float*)W6;
  k.fm = (const float*)fm;
  k.ei = (const int*)ei;
  k.ej = (const int*)ej;
  k.row_ptr = (const int*)row_ptr;
  k.inc = (const int2*)inc;
  k.pos = (const int*)pos;
  k.rp = nullptr;
  // scratch (floats), Mp = blocks * S: the device-memory hot set's x, p,
  // pn, z, r, Ap, d4, m4 (4 Mp each), d2, m2 (2 Mp each), ha, hb (8E each),
  // hc (2E); then P, C, b3 (3M each), Hii6, Hjj6 (6E each), bi3, bj3 (3E
  // each): 36 Mp + 9M + 36E
  const size_t Mp = (size_t)blocks << logS;
  float4* v = (float4*)scratch;
  k.x = v;
  k.p = k.x + Mp;
  k.pn = k.p + Mp;
  k.z = k.pn + Mp;
  k.r = k.z + Mp;
  k.Ap = k.r + Mp;
  k.d4 = k.Ap + Mp;
  k.m4 = k.d4 + Mp;
  k.d2 = (float2*)(k.m4 + Mp);
  k.m2 = k.d2 + Mp;
  k.ha = (float4*)(k.m2 + Mp);
  k.hb = k.ha + 2 * (size_t)E;
  k.hc = (float*)(k.hb + 2 * (size_t)E);
  const size_t m3 = 3 * (size_t)M;
  k.P = k.hc + 2 * (size_t)E;
  k.C = k.P + m3;
  k.b3 = k.C + m3;
  k.Hii6 = k.b3 + m3;
  k.Hjj6 = k.Hii6 + 6 * (size_t)E;
  k.bi3 = k.Hjj6 + 6 * (size_t)E;
  k.bj3 = k.bi3 + 3 * (size_t)E;
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t e = cudaMemcpyAsync(k.P, pT, m3 * sizeof(float),
                                  cudaMemcpyDeviceToDevice, st);
  if (e != cudaSuccess) return (int)e;
  const int threads = min(1 << logS, MAX_THREADS);
  if (restarts > 1)
    return smem > 0
               ? launch_cluster(pcg_lm_kernel<true, true>, blocks, threads,
                                smem, st, k, (float*)out, L, lam0, iters,
                                cg_iters, cg_tol, sq_min_delta, restarts)
               : launch_cluster(pcg_lm_kernel<false, true>, blocks, threads,
                                0, st, k, (float*)out, L, lam0, iters,
                                cg_iters, cg_tol, sq_min_delta, restarts);
  return smem > 0
             ? launch_cluster(pcg_lm_kernel<true, false>, blocks, threads,
                              smem, st, k, (float*)out, L, lam0, iters,
                              cg_iters, cg_tol, sq_min_delta, 1)
             : launch_cluster(pcg_lm_kernel<false, false>, blocks, threads, 0,
                              st, k, (float*)out, L, lam0, iters, cg_iters,
                              cg_tol, sq_min_delta, 1);
}
