// The whole doSPA Levenberg-Marquardt solve of a banded pose graph, with an
// exact block cyclic-reduction (CR) factorization, in one launch.
//
// Replaces: tpu_slam/solver/pallas_cr_lm.py::fused_cr_lm (Pallas kernel
// _make_kernel).
//
// What bounds it on the H100: latency, not bytes or FLOPs. The graph on this
// route (bench.py's 1,024-node pose graph: W = 6, K = 256 supernodes of
// n = 3W = 18 unknowns) needs a few MFLOP per LM step, but CR is log2(K)
// dependent levels, each a set of small dense n x n Cholesky
// factorizations, triangular solves and products, and the LM loop is a
// chain of such steps with a cost reduction and an accept/reject decision
// between them. Each level's critical path is one supernode's dense work.
//
// Design: one thread-block cluster of up to 8 blocks (one per SM, up to 8
// warps each, so a thread may hold 255 registers and the dense work does
// not spill; solver/cr_lm.py::launch_geometry sizes it) runs the whole
// solve, so every dependency is a cluster barrier and the LM loop never
// leaves the kernel.
// - A warp per active supernode. The elimination stages D, B_prev^T, B and
//   r into the warp's slice of shared memory, factors D by n column steps
//   (lane i owns row i) and solves the 2n+1 right-hand sides of
//   X1 = D^-1 B_prev^T, X2 = D^-1 B, Xr = D^-1 r with a lane per right-hand
//   side, its column held in registers (n is a template parameter). The
//   survivor's three n x n products spread their n^2 outputs over the
//   lanes, the five operand blocks staged in shared memory together.
//   This warp code is csrc/cr_warp.cuh, which cr_stream.cu shares.
// - Assembly, the candidate step and chi^2 run a thread per flat lane
//   f = a K + k (node a of supernode k), each block an even, contiguous
//   chunk of them.
// - Blocks exchange D, B, X1, X2, r, Xr, x and the poses through device
//   memory (L2; a supernode's blocks contiguous, so a warp's staging loads
//   are coalesced), read with ld.global.cg after each cluster barrier. The
//   chi^2 and ||delta||^2 sums are gathered through distributed shared
//   memory, every block adding the blocks' partial sums in rank order.
// Every sum has a fixed order and no atomics are used. The TPU kernel's
// lane rolls, masked-sublane extraction and VMEM gate are Mosaic
// workarounds and are not carried over.

#include <cooperative_groups.h>

#include "cluster.cuh"
#include "cr_edges.cuh"
#include "cr_warp.cuh"

namespace {

constexpr int K_MAX = 512;       // solver/cr_lm.py K_MAX: the route split
constexpr int MAX_WARPS = 8;     // warps per block (solver/cr_lm.py)
constexpr int MAX_CLUSTER = 8;   // portable cluster size
constexpr int MAX_THREADS = 32 * MAX_WARPS;

struct Ctx {
  int W, K, WK;
  const float* slots;  // (NBANKS * W * SLOT_ROWS, WK)
  const float* free;   // (WK,)
  float* P;            // (3, WK) current poses
  float* C;            // (3, WK) candidate poses
  float* D;            // (K, n, n)
  float* B;            // (K, n, n) coupling to the next active supernode
  float* X1;           // (K, n, n)
  float* X2;           // (K, n, n)
  float* r;            // (K, n)
  float* Xr;           // (K, n)
  float* x;            // (K, n)
  float* stage;        // (NBANKS * W * STAGE_ROWS, WK)
};

// Cluster-wide sum in a fixed order; every thread gets the total. Each
// block's partial goes to one of two slots (alternating, so that a slot
// is rewritten only after a later barrier), and every block adds the
// partials in rank order. Includes a cluster barrier.
__device__ float cluster_sum(float v, float* red, float* slots, int& parity) {
  v = block_sum(v, red);
  float* slot = slots + parity;
  parity ^= 1;
  if (threadIdx.x == 0) *slot = v;
  cluster_barrier();
  cg::cluster_group cl = cg::this_cluster();
  float s = 0.f;
  for (unsigned b = 0; b < cl.num_blocks(); ++b) s += *cl.map_shared_rank(slot, b);
  return s;
}

// Flat lanes f0, f0 + blockDim, ... < f1: each block takes an even,
// contiguous chunk of the W K flat lanes, so every SM shares the work.
#define FOR_FLAT(f, t) for (int f = (t).f0; f < (t).f1; f += blockDim.x)

// chi^2 of the whole graph at poses P: a thread per flat lane.
__device__ float graph_cost(const Ctx& c, const float* P, const Team& t,
                            float* red, float* cslots, int& parity) {
  float acc = 0.f;
  Edge e;
  FOR_FLAT(f, t) {
    const int a = f / c.K, k = f % c.K;
    for (int bank = 0; bank < NBANKS; ++bank)
      for (int d = 1; d <= c.W; ++d)
        if (edge_terms<Ctx, true>(c, P, bank, d, a, k, e)) acc += edge_cost(e);
  }
  return cluster_sum(acc, red, cslots, parity);
}

// D, B, r at poses P, damped by lam and gauge-fixed
// (banded.assemble_supernodes semantics), a thread per flat lane. The
// thread of node a of supernode k writes the D blocks (a, b) and (b, a)
// for b >= a, B's block row a and r's rows of a, so every entry has one
// writer. The high node's share of an edge goes through the stage to the
// thread of that node.
template <int N>
__device__ void assemble(const Ctx& c, float lam, const Team& t) {
  constexpr int W = N / 3;
  const int K = c.K, WK = c.WK;
  Edge e;
  float HLL[3][3], HLH[3][3], HHH[3][3], bL[3], bH[3];
  FOR_FLAT(f, t) {
    const int a = f / K, k = f % K;
    float* D = c.D + (size_t)k * N * N;
    float* B = c.B + (size_t)k * N * N;
    const float* fr = c.free;
    const int kn = (k + 1) % K;
    float Hd[3][3] = {}, rb[3] = {};
    for (int d = 1; d <= W; ++d) {
      float Hx[3][3] = {};
      for (int bank = 0; bank < NBANKS; ++bank) {
        if (!edge_terms<Ctx, true>(c, c.P, bank, d, a, k, e)) continue;
        edge_blocks(e, HLL, HLH, HHH, bL, bH);
        for (int u = 0; u < 3; ++u) {
          for (int v = 0; v < 3; ++v) {
            Hd[u][v] += HLL[u][v];
            Hx[u][v] += HLH[u][v];
          }
          rb[u] += bL[u];
        }
        float* st = c.stage +
                    (size_t)((bank * W + d - 1) * STAGE_ROWS) * WK + f;
        for (int u = 0; u < 3; ++u) {
          for (int v = 0; v < 3; ++v) st[(size_t)(3 * u + v) * WK] = HHH[u][v];
          st[(size_t)(9 + u) * WK] = bH[u];
        }
      }
      // block (a, a + d): inside the supernode (masked by both nodes'
      // flags), or the coupling to the next one (masked by its flags)
      const int bo = a + d;
      const float fa = fr[a * K + k];
      if (bo < W) {
        const float m = fa * fr[bo * K + k];
        for (int u = 0; u < 3; ++u)
          for (int v = 0; v < 3; ++v) {
            D[(3 * a + u) * N + 3 * bo + v] = Hx[u][v] * m;
            D[(3 * bo + v) * N + 3 * a + u] = Hx[u][v] * m;
          }
      } else {
        const float m = fa * fr[(bo - W) * K + kn];
        for (int u = 0; u < 3; ++u)
          for (int v = 0; v < 3; ++v)
            B[(3 * a + u) * N + 3 * (bo - W) + v] = Hx[u][v] * m;
      }
    }
    // B's blocks (a, b > a) take no edge: their nodes are a whole band apart
    for (int u = 0; u < 3; ++u)
      for (int j = 3 * a + 3; j < N; ++j) B[(3 * a + u) * N + j] = 0.f;
    for (int u = 0; u < 3; ++u) {
      for (int v = 0; v < 3; ++v) D[(3 * a + u) * N + 3 * a + v] = Hd[u][v];
      c.r[(size_t)k * N + 3 * a + u] = rb[u];
    }
  }
  cluster_barrier();
  // the high nodes' shares, gathered by their owners; then damping (jitter,
  // then x (1 + lambda) on the diagonal) and the gauge / padding mask on
  // the diagonal block and r: non-free rows and columns zeroed, identity
  // on the diagonal
  const float one_lam = 1.f + lam;
  FOR_FLAT(f, t) {
    const int a = f / K, k = f % K;
    float* D = c.D + (size_t)k * N * N + 3 * a * N + 3 * a;
    float* r = c.r + (size_t)k * N + 3 * a;
    float Hd[3][3], rb[3];
    for (int u = 0; u < 3; ++u) {
      for (int v = 0; v < 3; ++v) Hd[u][v] = D[u * N + v];
      rb[u] = r[u];
    }
    const int p = k * W + a;  // chain position of this node
    for (int bank = 0; bank < NBANKS; ++bank)
      for (int d = 1; d <= W; ++d) {
        const int pl = p - d;
        if (pl < 0) continue;
        const int fl = (pl % W) * K + pl / W;
        const float* sl =
            c.slots + (size_t)((bank * W + d - 1) * SLOT_ROWS) * WK + fl;
        bool any = false;
        for (int q = 0; q < 6; ++q) any |= sl[(size_t)(3 + q) * WK] != 0.f;
        if (!any) continue;
        const float* st =
            c.stage + (size_t)((bank * W + d - 1) * STAGE_ROWS) * WK + fl;
        for (int u = 0; u < 3; ++u) {
          for (int v = 0; v < 3; ++v) Hd[u][v] += ld(st + (size_t)(3 * u + v) * WK);
          rb[u] += ld(st + (size_t)(9 + u) * WK);
        }
      }
    const float fa = c.free[f];
    for (int u = 0; u < 3; ++u) {
      Hd[u][u] = (Hd[u][u] + 1e-12f) * one_lam;
      for (int v = 0; v < 3; ++v) D[u * N + v] = Hd[u][v] * fa * fa;
      D[u * N + u] += 1.f - fa;
      r[u] = -rb[u] * fa;
    }
  }
  cluster_barrier();
}

template <int W>
__global__ void __launch_bounds__(MAX_THREADS, 1)
    cr_lm_kernel(const float* __restrict__ pT8, const float* __restrict__ slots,
                 float* __restrict__ out, float* scratch, float lam0, int K,
                 int iters, float sq_min_delta) {
  constexpr int N = 3 * W;
  extern __shared__ float dyn[];
  __shared__ float red[33];
  __shared__ float cslots[2];
  cg::cluster_group cl = cg::this_cluster();
  Team t;
  const int chunk = (W * K + cl.num_blocks() - 1) / cl.num_blocks();
  t.f0 = cl.block_rank() * chunk + threadIdx.x;
  t.f1 = min(W * K, ((int)cl.block_rank() + 1) * chunk);
  t.lane = threadIdx.x & 31;
  t.gwarp = (cl.block_rank() * blockDim.x + threadIdx.x) >> 5;
  t.nwarps = cl.num_blocks() * blockDim.x >> 5;
  float* sm = dyn + (threadIdx.x >> 5) * warp_floats(N);
  int parity = 0;

  Ctx c;
  c.W = W;
  c.K = K;
  c.WK = W * K;
  const int WK = c.WK;
  const size_t nnK = (size_t)N * N * K, nK = (size_t)N * K;
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

  FOR_FLAT(f, t)
    for (int u = 0; u < 3; ++u) c.P[u * WK + f] = pT8[u * WK + f];
  cluster_barrier();

  const float cost0 = graph_cost(c, c.P, t, red, cslots, parity);
  float lam = lam0, laminc = 2.f, cost = cost0, good = 0.f;
  int it = 0;
  bool done = false;
  while (it < iters && !done) {
    assemble<N>(c, lam, t);
    cr_solve<N>(c, t, sm, 1);
    float sq = 0.f;
    FOR_FLAT(f, t) {
      const int a = f / K, k = f % K;
      for (int u = 0; u < 3; ++u) {
        const float dl = ld(c.x + (size_t)k * N + 3 * a + u) * c.free[f];
        sq += dl * dl;
        const float v = ld(c.P + u * WK + f) + dl;
        c.C[u * WK + f] = u == 2 ? wrap(v) : v;
      }
    }
    sq = cluster_sum(sq, red, cslots, parity);  // also publishes C
    const bool converged = sq < sq_min_delta;
    const float new_cost = graph_cost(c, c.C, t, red, cslots, parity);
    if (new_cost < cost && !converged) {  // accept: C becomes P
      float* tmp = c.P;
      c.P = c.C;
      c.C = tmp;
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
  FOR_FLAT(f, t) {
    for (int u = 0; u < 3; ++u) out[u * WK + f] = ld(c.P + u * WK + f);
    float s = 0.f;
    if (f == 0) s = cost0;
    if (f == 1) s = cost;
    if (f == 2) s = good;
    if (f == 3) s = (float)it;
    out[3 * WK + f] = s;
    for (int u = 4; u < 8; ++u) out[u * WK + f] = 0.f;
  }
  cl.sync();  // no block leaves while another may read its shared memory
}

}  // namespace

// One cluster of `blocks` blocks of `warps` warps with `smem` bytes of
// dynamic shared memory each (solver/cr_lm.py::launch_geometry). Returns a
// cudaError_t: non-zero when the arguments are out of range or the card
// refuses the cluster.
extern "C" int cr_lm_launch(const void* pT8, const void* slots, void* out,
                            void* scratch, float lam0, int W, int K,
                            int iters, float sq_min_delta, int blocks,
                            int warps, int smem, void* stream) {
  if (W < 1 || W > 8 || K < 32 || K > K_MAX || (K & (K - 1)) != 0 ||
      blocks < 1 || blocks > MAX_CLUSTER || warps < 1 || warps > MAX_WARPS ||
      smem < warps * warp_floats(3 * W) * (int)sizeof(float))
    return (int)cudaErrorInvalidValue;
  const float* p = (const float*)pT8;
  const float* s = (const float*)slots;
  float* o = (float*)out;
  float* sc = (float*)scratch;
  cudaStream_t st = (cudaStream_t)stream;
  switch (W) {
#define CR_LM_CASE(w)                                                      \
  case w:                                                                  \
    return launch_cluster(cr_lm_kernel<w>, blocks, 32 * warps, smem, st,   \
                          p, s, o, sc, lam0, K, iters, sq_min_delta);
    CR_LM_CASE(1)
    CR_LM_CASE(2)
    CR_LM_CASE(3)
    CR_LM_CASE(4)
    CR_LM_CASE(5)
    CR_LM_CASE(6)
    CR_LM_CASE(7)
    CR_LM_CASE(8)
#undef CR_LM_CASE
  }
  return (int)cudaErrorInvalidValue;
}
