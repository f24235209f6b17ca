// The whole doSPA Levenberg-Marquardt solve of a banded pose graph, with an
// exact block cyclic-reduction (CR) step, at any power-of-two number K of
// supernodes: per LM iteration a short train of grid-wide kernels and one
// thread-block cluster.
//
// Replaces: tpu_slam/solver/cr_stream.py::streamed_cr_lm (its Pallas
// kernels _make_assemble_kernel, _make_cost_kernel, _make_elim_kernel,
// _make_update_kernel and _make_backsub_kernel).
//
// What bounds it on the H100: latency, not bytes or FLOPs. One LM step on
// the 16,384-node ring (W = 6, K = 4,096 supernodes of n = 3W = 18
// unknowns) is ~0.3 GFLOP over ~20 MB of blocks, but CR is log2(K)
// dependent levels, each a small serial n x n Cholesky and triangular
// solve per supernode, and a level run as its own kernels costs their
// launches and the gaps between them.
//
// Design (solver/cr_stream.py::stream_schedule gives its shape):
// - The wide levels, h < h0 = K / 128, have more than 128 active
//   supernodes. Each is two grid launches, an elimination over the odd
//   survivors k = h (2j + 1) and a fold into the even ones k = 2hj, a warp
//   per supernode and WIDE_WARPS warps a block, with the warp code of
//   csrc/cr_warp.cuh (what cr_lm.cu runs): at K = 4,096 the first level's
//   2,048 eliminations fill the SMs with warps.
// - From level h0 on at most 128 supernodes are active. One cluster launch
//   (cr_lm.cu's design: up to 8 blocks of up to 8 warps, a warp per active
//   supernode, cluster barriers between levels; solver/cr_lm.py's
//   launch_geometry(W, K / h0) sizes it) runs the remaining levels, the
//   top solve and the back-substitution down to h0; the wide levels'
//   back-substitution follows, a grid launch each. The cluster could take
//   512 (K_MAX); measured on the H100, a cluster level of 256 or 512
//   supernodes (two or four rounds of its 64 warps) costs more than a
//   wide level's three launches, one of 128 about the same.
// - Assembly and chi^2 run a block per 32 flat lanes f = a K + k (node a
//   of supernode k) and a warp per slot distance, so that no thread walks
//   all of a lane's edges and neighbouring threads read neighbouring
//   lanes; the candidate step runs a thread per lane. Assembly
//   writes each entry of D, B and r once: a lane owns the blocks (a, b)
//   and (b, a) of D for b >= a, and recomputes the high-node terms of the
//   edges that end at it rather than reading them from their low node.
//   The cost kernel of the candidate also takes the LM decision: the last
//   of its blocks to finish (a ticket counter) sums the per-block partials
//   in block order, so every sum has a fixed order whichever block that
//   is.
// - The LM state (lambda, its increment, cost, counts, which of two pose
//   buffers holds the current poses, done) lives on the device, and every
//   kernel returns at once when done is set. The host enqueues CHUNK
//   iterations at a time and reads done between chunks, so at most
//   CHUNK - 1 iterations' launches run after convergence.
// So an LM iteration is 3 log2(h0) + 4 launches: 19 at K = 4,096, 13 at
// K = 1,024, 4 up to K = 128. The stored eliminations X1 = D^-1 B_prev^T,
// X2 = D^-1 B and Xr = D^-1 r sit at the eliminated supernode's own index,
// K (2n^2 + n) floats for all levels. The TPU pipeline's survivor
// compaction, lane shifts and chunking are layout work for its vector
// unit and are not carried over.

#include <cooperative_groups.h>

#include "cluster.cuh"
#include "cr_edges.cuh"
#include "cr_warp.cuh"

namespace {

constexpr int STATE_FLOATS = 16;  // room for State at the scratch's head
constexpr int BLOCK = 256;        // threads of the per-lane kernels
constexpr int LANES = 32;         // flat lanes a block of the edge kernels
constexpr int K_MAX = 512;        // active supernodes the cluster may take
constexpr int WIDE_WARPS = 4;     // warps a block of the wide levels
constexpr int MAX_WARPS = 8;      // warps a block of the cluster
constexpr int MAX_CLUSTER = 8;    // portable cluster size
constexpr int MAX_THREADS = 32 * MAX_WARPS;

struct State {
  float lam, laminc, cost, cost0, good, it;
  int cur;          // the pose buffer that holds the current poses
  int done;         // set once ||delta||^2 < sq_min_delta
  unsigned ticket;  // blocks of the running cost kernel that have finished
};
static_assert(sizeof(State) <= STATE_FLOATS * sizeof(float),
              "State outgrows its room in the scratch");

struct Ctx {
  int W, K, n, WK;
  int nblk;            // blocks of the per-lane kernels (a thread a lane)
  int eblk;            // blocks of the edge kernels (LANES lanes a block)
  const float* slots;  // (NBANKS * W * SLOT_ROWS, WK)
  const float* free;   // (WK,)
  State* st;
  float* P[2];         // two (3, WK) pose buffers: current and candidate
  float* D;            // (K, n, n)
  float* B;            // (K, n, n), coupling to the next active supernode
  float* X1;           // (K, n, n)
  float* X2;           // (K, n, n)
  float* r;            // (K, n)
  float* Xr;           // (K, n)
  float* x;            // (K, n)
  float* part_sq;      // (nblk,) per-block sums of ||delta||^2
  float* part_cost;    // (eblk,) per-block sums of chi^2
};

__device__ __forceinline__ float* mat(float* m, const Ctx& c, int k) {
  return m + (size_t)k * c.n * c.n;
}

// --- set-up, cost and the LM step ------------------------------------------

// The edge kernels run a block per LANES flat lanes f = a K + k and a warp
// per slot distance: thread (w, lane) of the block takes lane
// f = LANES blockIdx.x + lane and, for w < W, the edges of distance
// d = w + 1 (both banks) whose low node is f; in the assembly warp W + w
// takes those of distance w + 1 that end at f (recomputed from their low
// node's slots). Neighbouring threads take neighbouring lanes, so their
// loads of the slots and poses coalesce.
struct EdgeThread {
  int f, d;
  bool live;  // f < WK
  bool high;  // the edges that end at f
};

__device__ __forceinline__ EdgeThread edge_thread(const Ctx& c) {
  const int w = threadIdx.x >> 5, f = blockIdx.x * LANES + (threadIdx.x & 31);
  return {f, w % c.W + 1, f < c.WK, w >= c.W};
}

// chi^2 of this thread's low-node edges at poses P.
__device__ float edge_cost_sum(const Ctx& c, const float* P, EdgeThread t) {
  float acc = 0.f;
  if (t.live && !t.high) {
    const int a = t.f / c.K, k = t.f % c.K;
    Edge e;
    for (int bank = 0; bank < NBANKS; ++bank)
      if (edge_terms(c, P, bank, t.d, a, k, e)) acc += edge_cost(e);
  }
  return acc;
}

// Thread 0 has written this block's partial sums: take a ticket. True in
// every thread of the last block to finish, which then sees every
// block's partials (threadFenceReduction's pattern).
__device__ bool last_block(const Ctx& c) {
  __shared__ bool last;
  if (threadIdx.x == 0) {
    __threadfence();
    last = atomicAdd(&c.st->ticket, 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (last) __threadfence();
  return last;
}

// The per-block partials in block order; every thread gets the total.
__device__ float ordered_sum(const float* part, int nblk, float* red) {
  float q = 0.f;
  for (int b = threadIdx.x; b < nblk; b += blockDim.x) q += __ldcg(part + b);
  return block_sum(q, red);
}

// Copy the poses in and sum their chi^2; the last block sets the LM state
// (cost0 = cost). The host zeroes the state, and with it the ticket, first.
__global__ void cr_stream_setup_kernel(Ctx c, const float* __restrict__ pT8,
                                       float lam0) {
  __shared__ float red[33];
  const EdgeThread t = edge_thread(c);
  if (t.live && t.d == 1)
    for (int u = 0; u < 3; ++u) c.P[0][u * c.WK + t.f] = pT8[u * c.WK + t.f];
  const float acc = block_sum(edge_cost_sum(c, pT8, t), red);
  if (threadIdx.x == 0) c.part_cost[blockIdx.x] = acc;
  if (!last_block(c)) return;
  const float q = ordered_sum(c.part_cost, c.eblk, red);
  if (threadIdx.x == 0) {
    State* st = c.st;
    st->lam = lam0;
    st->laminc = 2.f;
    st->cost = st->cost0 = q;
    st->good = st->it = 0.f;
    st->cur = 0;
    st->done = 0;
    st->ticket = 0;
  }
}

// Flat lane f = a K + k (node a of supernode k, chain position p = k W + a)
// owns the blocks (a, b) and (b, a) of D for b >= a, B's block row a and
// r's rows of a, and each entry is written once
// (banded.assemble_supernodes semantics). A block's 32 lanes share a
// (K is a multiple of 32) and take supernodes k0 ... k0 + 31. Warp w < W
// sums the terms of the edges of distance d = w + 1 as their low node:
// block (a, a + d) of D, or of B past the supernode, and the transposed
// block (a + d, a) of D; warp W + w the high-node terms of the edges
// p - d -> p. Warp 0 sums the warps' diagonal-block and r terms in warp
// order, damps them (jitter, then x (1 + lambda) on the diagonal) and
// masks them: rows and columns of non-free nodes zeroed, identity on
// their diagonal. Rows 3a .. 3a + 2 of D (from column 3a on) and of B are
// staged in shared memory and written out by the whole block, a
// supernode's rows contiguous. Launched with 2 W warps a block.
__global__ void __launch_bounds__(2 * 8 * LANES)
    cr_stream_assemble_kernel(Ctx c) {
  __shared__ float part[2 * 8][12][LANES];  // each warp's Hd (9) and rb (3)
  __shared__ float rowD[LANES][3][24];      // rows 3a .. 3a + 2 of D
  __shared__ float rowB[LANES][3][24];      // and of B
  if (c.st->done) return;
  const EdgeThread t = edge_thread(c);
  const int W = c.W, K = c.K, n = c.n;
  const int f = t.live ? t.f : 0, a = f / K, k = f % K, d = t.d;
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const float* P = c.P[c.st->cur];
  const float* fr = c.free;
  const float fa = fr[f];
  float* D = mat(c.D, c, k);
  Edge e;
  float HLL[3][3], HLH[3][3], HHH[3][3], bL[3], bH[3];
  float Hd[3][3] = {}, rb[3] = {};
  if (t.live && !t.high) {
    const int bo = a + d;
    float Hx[3][3] = {};
    for (int bank = 0; bank < NBANKS; ++bank) {
      if (!edge_terms(c, P, bank, d, a, k, e)) continue;
      edge_blocks(e, HLL, HLH, HHH, bL, bH);
      for (int u = 0; u < 3; ++u) {
        for (int v = 0; v < 3; ++v) {
          Hd[u][v] += HLL[u][v];
          Hx[u][v] += HLH[u][v];
        }
        rb[u] += bL[u];
      }
    }
    // block (a, a + d): inside the supernode (masked by both nodes'
    // flags), or the coupling to the next one (masked by its flags)
    if (bo < W) {
      const float m = fa * fr[bo * K + k];
      for (int u = 0; u < 3; ++u)
        for (int v = 0; v < 3; ++v) {
          rowD[lane][u][3 * bo + v] = Hx[u][v] * m;
          D[(3 * bo + v) * n + 3 * a + u] = Hx[u][v] * m;
        }
    } else {
      const float m = fa * fr[(bo - W) * K + (k + 1) % K];
      for (int u = 0; u < 3; ++u)
        for (int v = 0; v < 3; ++v)
          rowB[lane][u][3 * (bo - W) + v] = Hx[u][v] * m;
    }
  } else if (t.live) {
    const int p = k * W + a;
    for (int bank = 0; bank < NBANKS && d <= p; ++bank) {
      if (!edge_terms(c, P, bank, d, (p - d) % W, (p - d) / W, e)) continue;
      edge_blocks(e, HLL, HLH, HHH, bL, bH);
      for (int u = 0; u < 3; ++u) {
        for (int v = 0; v < 3; ++v) Hd[u][v] += HHH[u][v];
        rb[u] += bH[u];
      }
    }
  }
  for (int u = 0; u < 3; ++u) {
    for (int v = 0; v < 3; ++v) part[w][3 * u + v][lane] = Hd[u][v];
    part[w][9 + u][lane] = rb[u];
  }
  __syncthreads();
  if (w == 0 && t.live) {
    for (int u = 0; u < 3; ++u) {
      for (int v = 0; v < 3; ++v) Hd[u][v] = part[0][3 * u + v][lane];
      rb[u] = part[0][9 + u][lane];
    }
    for (int o = 1; o < 2 * W; ++o)
      for (int u = 0; u < 3; ++u) {
        for (int v = 0; v < 3; ++v) Hd[u][v] += part[o][3 * u + v][lane];
        rb[u] += part[o][9 + u][lane];
      }
    const float one_lam = 1.f + c.st->lam;
    float* r = c.r + (size_t)k * n + 3 * a;
    for (int u = 0; u < 3; ++u) {
      Hd[u][u] = (Hd[u][u] + 1e-12f) * one_lam;
      for (int v = 0; v < 3; ++v)
        rowD[lane][u][3 * a + v] = Hd[u][v] * (fa * fa);
      rowD[lane][u][3 * a + u] += 1.f - fa;
      r[u] = -rb[u] * fa;
      // B's blocks (a, b > a) take no edge: a whole band apart
      for (int j = 3 * a + 3; j < n; ++j) rowB[lane][u][j] = 0.f;
    }
  }
  __syncthreads();
  // the staged rows, each supernode's contiguous: D's from column 3a on,
  // B's whole (its rows 3a .. 3a + 2 follow each other)
  const int f0 = blockIdx.x * LANES, ab = f0 / K, k0 = f0 % K;
  const int wd = n - 3 * ab;
  for (int q = threadIdx.x; q < LANES * 3 * wd; q += blockDim.x) {
    const int l = q / (3 * wd), u = q / wd % 3, j = 3 * ab + q % wd;
    if (f0 + l < c.WK)
      mat(c.D, c, k0 + l)[(3 * ab + u) * n + j] = rowD[l][u][j];
  }
  for (int q = threadIdx.x; q < LANES * 3 * n; q += blockDim.x) {
    const int l = q / (3 * n), u = q / n % 3, j = q % n;
    if (f0 + l < c.WK)
      mat(c.B, c, k0 + l)[(3 * ab + u) * n + j] = rowB[l][u][j];
  }
}

// --- the wide levels: a warp per supernode ---------------------------------

// Warp j of the grid at level h; false past the level's K / (2h)
// supernodes (the whole warp leaves together).
__device__ __forceinline__ bool wide_warp(const Ctx& c, int h, int& j) {
  j = blockIdx.x * WIDE_WARPS + (threadIdx.x >> 5);
  return j < c.K / (2 * h);
}

// Level h: eliminate the odd survivor k = h (2j + 1).
template <int N>
__global__ void __launch_bounds__(32 * WIDE_WARPS)
    cr_stream_elim_kernel(Ctx c, int h) {
  extern __shared__ float dyn[];
  int j;
  if (c.st->done || !wide_warp(c, h, j)) return;
  eliminate<N>(c, h * (2 * j + 1), h,
               dyn + (threadIdx.x >> 5) * warp_floats(N), threadIdx.x & 31);
}

// Level h: fold the eliminated neighbours into the even survivor k = 2hj.
template <int N>
__global__ void __launch_bounds__(32 * WIDE_WARPS)
    cr_stream_fold_kernel(Ctx c, int h) {
  extern __shared__ float dyn[];
  int j;
  if (c.st->done || !wide_warp(c, h, j)) return;
  fold<N>(c, 2 * h * j, h, dyn + (threadIdx.x >> 5) * warp_floats(N),
          threadIdx.x & 31);
}

// Level h: back-substitute the odd supernode k = h (2j + 1).
template <int N>
__global__ void __launch_bounds__(32 * WIDE_WARPS)
    cr_stream_backsub_kernel(Ctx c, int h) {
  extern __shared__ float dyn[];
  int j;
  if (c.st->done || !wide_warp(c, h, j)) return;
  back_substitute<N>(c, h * (2 * j + 1), h,
                     dyn + (threadIdx.x >> 5) * warp_floats(N),
                     threadIdx.x & 31);
}

// --- the deep levels: one cluster -------------------------------------------

// Levels h0 ... K / 2, the top solve and the back-substitution down to h0,
// a warp per active supernode (at most K_MAX of them) across the cluster.
template <int N>
__global__ void __launch_bounds__(MAX_THREADS, 1)
    cr_stream_cluster_kernel(Ctx c, int h0) {
  extern __shared__ float dyn[];
  if (c.st->done) return;  // the same for every block: no barrier is left
  cg::cluster_group cl = cg::this_cluster();
  Team t;
  t.lane = threadIdx.x & 31;
  t.gwarp = (cl.block_rank() * blockDim.x + threadIdx.x) >> 5;
  t.nwarps = cl.num_blocks() * blockDim.x >> 5;
  t.f0 = t.f1 = 0;
  cr_solve<N>(c, t, dyn + (threadIdx.x >> 5) * warp_floats(N), h0);
}

// --- the candidate and the LM decision --------------------------------------

// Lane f = a K + k: the step delta = x * free, the candidate pose with its
// heading wrapped, and the per-block sums of ||delta||^2.
__global__ void cr_stream_candidate_kernel(Ctx c) {
  __shared__ float red[33];
  if (c.st->done) return;
  const int cur = c.st->cur;
  const float* P = c.P[cur];
  float* C = c.P[1 - cur];
  const int f = blockIdx.x * blockDim.x + threadIdx.x;
  float sq = 0.f;
  if (f < c.WK) {
    const int a = f / c.K, k = f % c.K;
    for (int u = 0; u < 3; ++u) {
      const float dl = c.x[(size_t)k * c.n + 3 * a + u] * c.free[f];
      sq += dl * dl;
      const float v = P[u * c.WK + f] + dl;
      C[u * c.WK + f] = u == 2 ? wrap(v) : v;
    }
  }
  sq = block_sum(sq, red);
  if (threadIdx.x == 0) c.part_sq[blockIdx.x] = sq;
}

// chi^2 of the candidate, and in the last block to finish the decision
// (tpu_slam/solver/cr_stream.py:709-720): converged when ||delta||^2 <
// sq_min_delta; accepted when its cost is lower and the step has not
// converged.
__global__ void cr_stream_cost_accept_kernel(Ctx c, float sq_min_delta) {
  __shared__ float red[33];
  if (c.st->done) return;
  const float acc =
      block_sum(edge_cost_sum(c, c.P[1 - c.st->cur], edge_thread(c)), red);
  if (threadIdx.x == 0) c.part_cost[blockIdx.x] = acc;
  if (!last_block(c)) return;
  const float sq = ordered_sum(c.part_sq, c.nblk, red);
  const float q = ordered_sum(c.part_cost, c.eblk, red);
  if (threadIdx.x == 0) {
    State* st = c.st;
    const bool converged = sq < sq_min_delta;
    if (q < st->cost && !converged) {
      st->cur = 1 - st->cur;
      st->cost = q;
      st->lam = st->lam * 0.5f;
      st->good += 1.f;
    } else {
      st->lam = st->lam * st->laminc;
      st->laminc = st->laminc * 2.f;
    }
    st->it += 1.f;
    st->done = converged;
    st->ticket = 0;
  }
}

// The packed (8, WK) result: poses in rows 0..2, (cost0, cost, good,
// iterations) in row 3, lanes 0..3.
__global__ void cr_stream_pack_kernel(Ctx c, float* __restrict__ out) {
  const int f = blockIdx.x * blockDim.x + threadIdx.x;
  if (f >= c.WK) return;
  const State* st = c.st;
  const float* P = c.P[st->cur];
  for (int u = 0; u < 3; ++u) out[u * c.WK + f] = P[u * c.WK + f];
  float s = 0.f;
  if (f == 0) s = st->cost0;
  if (f == 1) s = st->cost;
  if (f == 2) s = st->good;
  if (f == 3) s = st->it;
  out[3 * c.WK + f] = s;
  for (int u = 4; u < 8; ++u) out[u * c.WK + f] = 0.f;
}

#define CHECK(call)                                  \
  do {                                               \
    const cudaError_t err_ = (call);                 \
    if (err_ != cudaSuccess) return (int)err_;       \
  } while (0)
#define LAUNCH_CHECK() CHECK(cudaGetLastError())

// The solve at n = N: set-up, `iters` LM iterations in chunks of `chunk`
// (done read between chunks), and the packing of the result.
template <int N>
int run(const Ctx& c, const float* pT8, float* out, float lam0, int iters,
        float sq_min_delta, int h0, int blocks, int warps, int smem,
        int chunk, cudaStream_t st) {
  const int wide_threads = 32 * WIDE_WARPS;
  const int wide_smem = WIDE_WARPS * warp_floats(N) * (int)sizeof(float);
  CHECK(cudaFuncSetAttribute(cr_stream_elim_kernel<N>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             wide_smem));
  CHECK(cudaFuncSetAttribute(cr_stream_fold_kernel<N>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             wide_smem));
  CHECK(cudaFuncSetAttribute(cr_stream_backsub_kernel<N>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             wide_smem));
  ClusterLaunch cl;
  const int err = cluster_config(cr_stream_cluster_kernel<N>, blocks,
                                 32 * warps, smem, st, cl);
  if (err != 0) return err;
  const int K = c.K;
  CHECK(cudaMemsetAsync(c.st, 0, sizeof(State), st));
  cr_stream_setup_kernel<<<c.eblk, 32 * c.W, 0, st>>>(c, pT8, lam0);
  LAUNCH_CHECK();
  for (int it0 = 0; it0 < iters; it0 += chunk) {
    if (it0 > 0) {
      int done = 0;
      CHECK(cudaMemcpyAsync(&done, &c.st->done, sizeof(int),
                            cudaMemcpyDeviceToHost, st));
      CHECK(cudaStreamSynchronize(st));
      if (done) break;
    }
    for (int it = it0; it < iters && it < it0 + chunk; ++it) {
      cr_stream_assemble_kernel<<<c.eblk, 64 * c.W, 0, st>>>(c);
      LAUNCH_CHECK();
      for (int h = 1; h < h0; h <<= 1) {
        const int grid = (K / (2 * h) + WIDE_WARPS - 1) / WIDE_WARPS;
        cr_stream_elim_kernel<N><<<grid, wide_threads, wide_smem, st>>>(c, h);
        LAUNCH_CHECK();
        cr_stream_fold_kernel<N><<<grid, wide_threads, wide_smem, st>>>(c, h);
        LAUNCH_CHECK();
      }
      CHECK(cudaLaunchKernelEx(&cl.cfg, cr_stream_cluster_kernel<N>, c, h0));
      for (int h = h0 / 2; h >= 1; h >>= 1) {
        const int grid = (K / (2 * h) + WIDE_WARPS - 1) / WIDE_WARPS;
        cr_stream_backsub_kernel<N>
            <<<grid, wide_threads, wide_smem, st>>>(c, h);
        LAUNCH_CHECK();
      }
      cr_stream_candidate_kernel<<<c.nblk, BLOCK, 0, st>>>(c);
      LAUNCH_CHECK();
      cr_stream_cost_accept_kernel<<<c.eblk, 32 * c.W, 0, st>>>(c,
                                                               sq_min_delta);
      LAUNCH_CHECK();
    }
  }
  cr_stream_pack_kernel<<<c.nblk, BLOCK, 0, st>>>(c, out);
  LAUNCH_CHECK();
  return 0;
}

}  // namespace

// The whole solve on `stream`. h0 (a power of two, K / h0 <= K_MAX) is
// the first level the cluster of `blocks` blocks of `warps` warps with
// `smem` bytes of dynamic shared memory each runs; the host reads the
// device's done flag every `chunk` iterations and blocks until then
// (solver/cr_stream.py::stream_schedule gives all four). Returns a
// cudaError_t: non-zero when the arguments are out of range, the card
// refuses the cluster, or a launch fails.
extern "C" int cr_stream_launch(const void* pT8, const void* slots,
                                void* out, void* scratch, float lam0, int W,
                                int K, int iters, float sq_min_delta, int h0,
                                int blocks, int warps, int smem, int chunk,
                                void* stream) {
  if (W < 1 || W > 8 || K < 128 || (K & (K - 1)) != 0 || h0 < 1 ||
      (h0 & (h0 - 1)) != 0 || h0 >= K || K / h0 > K_MAX || blocks < 1 ||
      blocks > MAX_CLUSTER || warps < 1 || warps > MAX_WARPS ||
      smem < warps * warp_floats(3 * W) * (int)sizeof(float) || chunk < 1)
    return (int)cudaErrorInvalidValue;
  Ctx c;
  c.W = W;
  c.K = K;
  c.n = 3 * W;
  c.WK = W * K;
  c.nblk = (c.WK + BLOCK - 1) / BLOCK;
  c.eblk = (c.WK + LANES - 1) / LANES;
  const size_t WK = c.WK, nnK = (size_t)c.n * c.n * K, nK = (size_t)c.n * K;
  c.slots = (const float*)slots;
  c.free = (const float*)pT8 + 3 * WK;
  float* s = (float*)scratch;
  c.st = (State*)s;
  c.P[0] = s + STATE_FLOATS;
  c.P[1] = c.P[0] + 3 * WK;
  c.D = c.P[1] + 3 * WK;
  c.B = c.D + nnK;
  c.X1 = c.B + nnK;
  c.X2 = c.X1 + nnK;
  c.r = c.X2 + nnK;
  c.Xr = c.r + nK;
  c.x = c.Xr + nK;
  c.part_sq = c.x + nK;
  c.part_cost = c.part_sq + c.nblk;
  const float* p = (const float*)pT8;
  float* o = (float*)out;
  cudaStream_t st = (cudaStream_t)stream;
  switch (W) {
#define CR_STREAM_CASE(w)                                                   \
  case w:                                                                   \
    return run<3 * w>(c, p, o, lam0, iters, sq_min_delta, h0, blocks, warps, \
                      smem, chunk, st);
    CR_STREAM_CASE(1)
    CR_STREAM_CASE(2)
    CR_STREAM_CASE(3)
    CR_STREAM_CASE(4)
    CR_STREAM_CASE(5)
    CR_STREAM_CASE(6)
    CR_STREAM_CASE(7)
    CR_STREAM_CASE(8)
#undef CR_STREAM_CASE
  }
  return (int)cudaErrorInvalidValue;
}
