// The whole doSPA Levenberg-Marquardt solve of a banded pose graph, with an
// exact block cyclic-reduction (CR) step, at any power-of-two number K of
// supernodes: one train of grid-wide kernels per solve.
//
// Replaces: tpu_slam/solver/cr_stream.py::streamed_cr_lm (its Pallas
// kernels _make_assemble_kernel, _make_cost_kernel, _make_elim_kernel,
// _make_update_kernel and _make_backsub_kernel).
//
// What bounds it on the H100: latency, not bytes or FLOPs. One LM step on
// the 16,384-node ring (W = 6, K = 4,096 supernodes of n = 3W = 18
// unknowns) is ~0.3 GFLOP over ~20 MB of blocks, but CR is log2(K)
// dependent levels, each a small serial n x n Cholesky and triangular
// solve per supernode, and every level costs two launches: about
// 3 log2(K) + 6 launches per LM iteration (42 at K = 4,096).
//
// Design: each level is two kernels, an elimination over the odd
// survivors k = h(2j+1) and an update over the even ones k = 2hj, one
// block per supernode; survivors are addressed by stride, so nothing is
// compacted or shifted between levels. A block works on its supernode's
// n x n blocks in shared memory: the Cholesky column by column across the
// block's threads, then one thread per right-hand-side column of
// [B_prev^T | B | r]. The blocks live in device memory as [supernode][row]
// [col], so the threads of a block read neighbouring addresses; the
// stored eliminations X1 = D^-1 B_prev^T, X2 = D^-1 B and Xr = D^-1 r sit
// at the eliminated supernode's own index, K (2n^2 + n) floats for all
// levels. Assembly runs one thread per flat lane f = a K + k (node a of
// supernode k): each block of D belongs to the lane of its smaller node
// offset, and the high nodes' shares go through a staging array that
// their owner gathers, so every sum has a fixed order and there are no
// atomics. The cost is a per-lane chi^2 and a two-pass fixed-order sum.
// The LM state (lambda, its increment, cost, counts, which of two pose
// buffers holds the current poses, done) lives on the device: every
// kernel of an iteration returns at once when done is set, so the host
// enqueues the whole train and reads nothing. The TPU pipeline's survivor
// compaction, lane shifts and chunking are layout work for its vector
// unit and are not carried over.

#include "cr_edges.cuh"

namespace {

constexpr int STATE_FLOATS = 16;   // room for State at the scratch's head
constexpr int BLOCK = 256;         // threads of the per-lane kernels
constexpr int NMAX = 24;           // n = 3W, W <= 8
constexpr int ELIM_THREADS = 64;   // >= 2 NMAX + 1 right-hand sides
constexpr int UPDATE_THREADS = 128;

struct State {
  float lam, laminc, cost, cost0, good, it;
  int cur;   // the pose buffer that holds the current poses
  int done;  // set once ||delta||^2 < sq_min_delta
};

struct Ctx {
  int W, K, n, WK, nblk;
  const float* slots;  // (NBANKS * W * SLOT_ROWS, WK)
  const float* free;   // (WK,)
  State* st;
  float* P[2];         // two (3, WK) pose buffers: current and candidate
  float* stage;        // (NBANKS * W * STAGE_ROWS, WK)
  float* D;            // (K, n, n)
  float* B;            // (K, n, n), coupling to the next active supernode
  float* X1;           // (K, n, n)
  float* X2;           // (K, n, n)
  float* r;            // (K, n)
  float* Xr;           // (K, n)
  float* x;            // (K, n)
  float* part_sq;      // (nblk,) per-block sums of ||delta||^2
  float* part_cost;    // (nblk,) per-block sums of chi^2
};

__device__ __forceinline__ float* mat(float* m, const Ctx& c, int k) {
  return m + (size_t)k * c.n * c.n;
}

// --- set-up, cost and the LM step ------------------------------------------

__global__ void cr_stream_start_kernel(Ctx c, const float* __restrict__ pT8,
                             float lam0) {
  const int f = blockIdx.x * blockDim.x + threadIdx.x;
  if (f == 0) {
    State* st = c.st;
    st->lam = lam0;
    st->laminc = 2.f;
    st->cost = st->cost0 = st->good = st->it = 0.f;
    st->cur = 0;
    st->done = 0;
  }
  if (f < c.WK)
    for (int u = 0; u < 3; ++u) c.P[0][u * c.WK + f] = pT8[u * c.WK + f];
}

// Per-block sums of the lanes' chi^2 at the current poses, or at the
// candidate's.
__global__ void cr_stream_cost_kernel(Ctx c, int candidate) {
  __shared__ float red[33];
  if (c.st->done) return;
  const int cur = c.st->cur;
  const float* P = c.P[candidate ? 1 - cur : cur];
  const int f = blockIdx.x * blockDim.x + threadIdx.x;
  float acc = 0.f;
  if (f < c.WK) {
    const int a = f / c.K, k = f % c.K;
    Edge e;
    for (int bank = 0; bank < NBANKS; ++bank)
      for (int d = 1; d <= c.W; ++d)
        if (edge_terms(c, P, bank, d, a, k, e)) acc += edge_cost(e);
  }
  acc = block_sum(acc, red);
  if (threadIdx.x == 0) c.part_cost[blockIdx.x] = acc;
}

// The initial cost: the partial sums in a fixed order.
__global__ void cr_stream_cost0_kernel(Ctx c) {
  __shared__ float red[33];
  float q = 0.f;
  for (int b = threadIdx.x; b < c.nblk; b += blockDim.x) q += c.part_cost[b];
  q = block_sum(q, red);
  if (threadIdx.x == 0) c.st->cost0 = c.st->cost = q;
}

// Lane f = a K + k: zero the D, B and r entries it owns (block (i, j) of D
// belongs to lane min(i, j)), add its edges' low-node terms and stage the
// high node's share (banded.assemble_supernodes semantics).
__global__ void cr_stream_assemble_kernel(Ctx c) {
  if (c.st->done) return;
  const int f = blockIdx.x * blockDim.x + threadIdx.x;
  if (f >= c.WK) return;
  const int W = c.W, K = c.K, n = c.n, a = f / K, k = f % K;
  const float* P = c.P[c.st->cur];
  float* Dk = mat(c.D, c, k);
  float* Bk = mat(c.B, c, k);
  float* rk = c.r + (size_t)k * n;
  for (int u = 0; u < 3; ++u) {
    const int i = 3 * a + u;
    for (int j = 3 * a; j < n; ++j) Dk[i * n + j] = 0.f;
    for (int j = 0; j < n; ++j) Bk[i * n + j] = 0.f;
    rk[i] = 0.f;
  }
  for (int i = 3 * a + 3; i < n; ++i)
    for (int v = 0; v < 3; ++v) Dk[i * n + 3 * a + v] = 0.f;
  Edge e;
  float HLL[3][3], HLH[3][3], HHH[3][3], bL[3], bH[3];
  for (int bank = 0; bank < NBANKS; ++bank)
    for (int d = 1; d <= W; ++d) {
      if (!edge_terms(c, P, bank, d, a, k, e)) continue;
      edge_blocks(e, HLL, HLH, HHH, bL, bH);
      const int bo = a + d;
      for (int u = 0; u < 3; ++u) {
        for (int v = 0; v < 3; ++v) {
          Dk[(3 * a + u) * n + 3 * a + v] += HLL[u][v];
          if (bo < W) {
            Dk[(3 * a + u) * n + 3 * bo + v] += HLH[u][v];
            Dk[(3 * bo + v) * n + 3 * a + u] += HLH[u][v];
          } else {
            Bk[(3 * a + u) * n + 3 * (bo - W) + v] += HLH[u][v];
          }
        }
        rk[3 * a + u] += bL[u];
      }
      float* st = c.stage + (size_t)((bank * W + d - 1) * STAGE_ROWS) * c.WK + f;
      for (int u = 0; u < 3; ++u) {
        for (int v = 0; v < 3; ++v) st[(size_t)(3 * u + v) * c.WK] = HHH[u][v];
        st[(size_t)(9 + u) * c.WK] = bH[u];
      }
    }
}

// Lane f = a K + k: gather the staged high-node shares into its diagonal
// block and r, then damp (jitter, then x (1 + lambda) on the diagonal) and
// mask its entries: rows and columns of non-free nodes zeroed, identity on
// their diagonal.
__global__ void cr_stream_gather_kernel(Ctx c) {
  if (c.st->done) return;
  const int f = blockIdx.x * blockDim.x + threadIdx.x;
  if (f >= c.WK) return;
  const int W = c.W, K = c.K, n = c.n, a = f / K, k = f % K;
  float* Dk = mat(c.D, c, k);
  float* Bk = mat(c.B, c, k);
  float* rk = c.r + (size_t)k * n;
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
          Dk[(3 * a + u) * n + 3 * a + v] += st[(size_t)(3 * u + v) * c.WK];
        rk[3 * a + u] += st[(size_t)(9 + u) * c.WK];
      }
    }
  const float one_lam = 1.f + c.st->lam;
  for (int u = 0; u < 3; ++u) {
    float& dii = Dk[(3 * a + u) * n + 3 * a + u];
    dii = (dii + 1e-12f) * one_lam;
  }
  const float fa = c.free[f];
  const int kn = (k + 1) % K;
  for (int u = 0; u < 3; ++u) {
    const int i = 3 * a + u;
    for (int j = 3 * a; j < n; ++j) Dk[i * n + j] *= fa * c.free[(j / 3) * K + k];
    for (int j = 0; j < n; ++j) Bk[i * n + j] *= fa * c.free[(j / 3) * K + kn];
    Dk[i * n + i] += 1.f - fa;
    rk[i] = -rk[i] * fa;
  }
  for (int i = 3 * a + 3; i < n; ++i)
    for (int v = 0; v < 3; ++v)
      Dk[i * n + 3 * a + v] *= c.free[(i / 3) * K + k] * fa;
}

// Level h: eliminate the odd survivor k = h (2 blockIdx.x + 1): the
// Cholesky of D_k (pivot floor 1e-30), then [X1 | X2 | Xr] =
// D_k^-1 [B_{k-h}^T | B_k | r_k]. With h = K it is the top solve of
// supernode 0 alone: x_0 = D_0^-1 r_0.
__global__ void cr_stream_elim_kernel(Ctx c, int h) {
  __shared__ float L[NMAX * NMAX];
  __shared__ float Y[NMAX * (2 * NMAX + 1)];
  if (c.st->done) return;
  const int n = c.n, t = threadIdx.x, nt = blockDim.x;
  const bool top = h >= c.K;
  const int k = top ? 0 : h * (2 * blockIdx.x + 1);
  const int ncol = top ? 1 : 2 * n + 1;
  const float* Dk = mat(c.D, c, k);
  const float* Be = top ? nullptr : mat(c.B, c, k - h);
  const float* Bk = mat(c.B, c, k);
  const float* rk = c.r + (size_t)k * n;
  for (int q = t; q < n * n; q += nt) L[q] = Dk[q];
  for (int q = t; q < n * ncol; q += nt) {
    const int i = q / ncol, j = q % ncol;
    float y;
    if (j == ncol - 1) y = rk[i];
    else if (j < n) y = Be[j * n + i];
    else y = Bk[i * n + j - n];
    Y[q] = y;
  }
  __syncthreads();
  for (int j = 0; j < n; ++j) {
    const float ljj = sqrtf(fmaxf(L[j * n + j], 1e-30f));
    __syncthreads();
    if (t == 0) L[j * n + j] = ljj;
    for (int i = j + 1 + t; i < n; i += nt) L[i * n + j] /= ljj;
    __syncthreads();
    const int w = n - j - 1;
    for (int q = t; q < w * w; q += nt) {
      const int i = j + 1 + q / w, m = j + 1 + q % w;
      if (m <= i) L[i * n + m] -= L[i * n + j] * L[m * n + j];
    }
    __syncthreads();
  }
  if (t < ncol) {
    for (int i = 0; i < n; ++i) {
      float s = Y[i * ncol + t];
      for (int m = 0; m < i; ++m) s -= L[i * n + m] * Y[m * ncol + t];
      Y[i * ncol + t] = s / L[i * n + i];
    }
    for (int i = n - 1; i >= 0; --i) {
      float s = Y[i * ncol + t];
      for (int m = i + 1; m < n; ++m) s -= L[m * n + i] * Y[m * ncol + t];
      Y[i * ncol + t] = s / L[i * n + i];
    }
  }
  __syncthreads();
  if (top) {
    for (int i = t; i < n; i += nt) c.x[i] = Y[i];
    return;
  }
  float* X1 = mat(c.X1, c, k);
  float* X2 = mat(c.X2, c, k);
  for (int q = t; q < n * n; q += nt) {
    const int i = q / n, j = q % n;
    X1[q] = Y[i * ncol + j];
    X2[q] = Y[i * ncol + n + j];
  }
  for (int i = t; i < n; i += nt) c.Xr[(size_t)k * n + i] = Y[i * ncol + 2 * n];
}

// Level h: fold the eliminated neighbours into the even survivor
// k = 2 h blockIdx.x: D_k -= B_{k-h}^T X2_{k-h} + B_k X1_{k+h},
// r_k -= B_{k-h}^T Xr_{k-h} + B_k Xr_{k+h}, and the new coupling to
// k + 2h, B_k = -B_k X2_{k+h} (zero past the last survivor).
__global__ void cr_stream_update_kernel(Ctx c, int h) {
  __shared__ float Bk[NMAX * NMAX], Bl[NMAX * NMAX], X1r[NMAX * NMAX],
      X2r[NMAX * NMAX], X2l[NMAX * NMAX], Xrr[NMAX], Xrl[NMAX];
  if (c.st->done) return;
  const int n = c.n, t = threadIdx.x, nt = blockDim.x;
  const int k = 2 * h * blockIdx.x, o = k + h, ol = k - h;
  const bool left = k > 0, more = o + h < c.K;
  for (int q = t; q < n * n; q += nt) {
    Bk[q] = mat(c.B, c, k)[q];
    X1r[q] = mat(c.X1, c, o)[q];
    X2r[q] = mat(c.X2, c, o)[q];
    if (left) {
      Bl[q] = mat(c.B, c, ol)[q];
      X2l[q] = mat(c.X2, c, ol)[q];
    }
  }
  for (int i = t; i < n; i += nt) {
    Xrr[i] = c.Xr[(size_t)o * n + i];
    if (left) Xrl[i] = c.Xr[(size_t)ol * n + i];
  }
  __syncthreads();
  float* Dk = mat(c.D, c, k);
  float* Bout = mat(c.B, c, k);
  for (int q = t; q < n * n; q += nt) {
    const int i = q / n, j = q % n;
    float tl = 0.f, tr = 0.f, nb = 0.f;
    if (left)
      for (int m = 0; m < n; ++m) tl += Bl[m * n + i] * X2l[m * n + j];
    for (int m = 0; m < n; ++m) tr += Bk[i * n + m] * X1r[m * n + j];
    if (more)
      for (int m = 0; m < n; ++m) nb += Bk[i * n + m] * X2r[m * n + j];
    Dk[q] = Dk[q] - tl - tr;
    Bout[q] = -nb;
  }
  for (int i = t; i < n; i += nt) {
    float tl = 0.f, tr = 0.f;
    if (left)
      for (int m = 0; m < n; ++m) tl += Bl[m * n + i] * Xrl[m];
    for (int m = 0; m < n; ++m) tr += Bk[i * n + m] * Xrr[m];
    float& ri = c.r[(size_t)k * n + i];
    ri = ri - tl - tr;
  }
}

// Back-substitution at level h, odd k = h (2 blockIdx.x + 1), one thread
// per row: x_k = Xr_k - X1_k x_{k-h} - X2_k x_{k+h}.
__global__ void cr_stream_backsub_kernel(Ctx c, int h) {
  if (c.st->done) return;
  const int n = c.n, i = threadIdx.x;
  if (i >= n) return;
  const int k = h * (2 * blockIdx.x + 1), e = k - h, g = k + h;
  const float* X1 = mat(c.X1, c, k);
  const float* X2 = mat(c.X2, c, k);
  float s = c.Xr[(size_t)k * n + i];
  for (int m = 0; m < n; ++m) s -= X1[i * n + m] * c.x[(size_t)e * n + m];
  if (g < c.K)
    for (int m = 0; m < n; ++m) s -= X2[i * n + m] * c.x[(size_t)g * n + m];
  c.x[(size_t)k * n + i] = s;
}

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

// Accept or reject the candidate (tpu_slam/solver/cr_stream.py:709-720):
// converged when ||delta||^2 < sq_min_delta; accepted when its cost is
// lower and the step has not converged.
__global__ void cr_stream_accept_kernel(Ctx c, float sq_min_delta) {
  __shared__ float red[33];
  if (c.st->done) return;
  float sq = 0.f, q = 0.f;
  for (int b = threadIdx.x; b < c.nblk; b += blockDim.x) {
    sq += c.part_sq[b];
    q += c.part_cost[b];
  }
  sq = block_sum(sq, red);
  q = block_sum(q, red);
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

}  // namespace

#define LAUNCH_CHECK()                           \
  do {                                           \
    const cudaError_t err = cudaGetLastError();  \
    if (err != cudaSuccess) return (int)err;     \
  } while (0)

// Enqueue the whole solve on `stream`: set-up and the initial cost, `iters`
// LM iterations of 3 log2(K) + 6 launches, and the packing of the result.
extern "C" int cr_stream_launch(const void* pT8, const void* slots,
                                void* out, void* scratch, float lam0, int W,
                                int K, int iters, float sq_min_delta,
                                void* stream) {
  Ctx c;
  c.W = W;
  c.K = K;
  c.n = 3 * W;
  c.WK = W * K;
  c.nblk = (c.WK + BLOCK - 1) / BLOCK;
  const size_t WK = c.WK, nnK = (size_t)c.n * c.n * K, nK = (size_t)c.n * K;
  c.slots = (const float*)slots;
  c.free = (const float*)pT8 + 3 * WK;
  float* s = (float*)scratch;
  c.st = (State*)s;
  c.P[0] = s + STATE_FLOATS;
  c.P[1] = c.P[0] + 3 * WK;
  c.stage = c.P[1] + 3 * WK;
  c.D = c.stage + (size_t)NBANKS * W * STAGE_ROWS * WK;
  c.B = c.D + nnK;
  c.X1 = c.B + nnK;
  c.X2 = c.X1 + nnK;
  c.r = c.X2 + nnK;
  c.Xr = c.r + nK;
  c.x = c.Xr + nK;
  c.part_sq = c.x + nK;
  c.part_cost = c.part_sq + c.nblk;

  cudaStream_t st = (cudaStream_t)stream;
  cr_stream_start_kernel<<<c.nblk, BLOCK, 0, st>>>(c, (const float*)pT8, lam0);
  LAUNCH_CHECK();
  cr_stream_cost_kernel<<<c.nblk, BLOCK, 0, st>>>(c, 0);
  LAUNCH_CHECK();
  cr_stream_cost0_kernel<<<1, BLOCK, 0, st>>>(c);
  LAUNCH_CHECK();
  for (int it = 0; it < iters; ++it) {
    cr_stream_assemble_kernel<<<c.nblk, BLOCK, 0, st>>>(c);
    LAUNCH_CHECK();
    cr_stream_gather_kernel<<<c.nblk, BLOCK, 0, st>>>(c);
    LAUNCH_CHECK();
    for (int h = 1; h < K; h <<= 1) {
      cr_stream_elim_kernel<<<K / (2 * h), ELIM_THREADS, 0, st>>>(c, h);
      LAUNCH_CHECK();
      cr_stream_update_kernel<<<K / (2 * h), UPDATE_THREADS, 0, st>>>(c, h);
      LAUNCH_CHECK();
    }
    cr_stream_elim_kernel<<<1, ELIM_THREADS, 0, st>>>(c, K);
    LAUNCH_CHECK();
    for (int h = K / 2; h >= 1; h >>= 1) {
      cr_stream_backsub_kernel<<<K / (2 * h), 32, 0, st>>>(c, h);
      LAUNCH_CHECK();
    }
    cr_stream_candidate_kernel<<<c.nblk, BLOCK, 0, st>>>(c);
    LAUNCH_CHECK();
    cr_stream_cost_kernel<<<c.nblk, BLOCK, 0, st>>>(c, 1);
    LAUNCH_CHECK();
    cr_stream_accept_kernel<<<1, BLOCK, 0, st>>>(c, sq_min_delta);
    LAUNCH_CHECK();
  }
  cr_stream_pack_kernel<<<c.nblk, BLOCK, 0, st>>>(c, (float*)out);
  LAUNCH_CHECK();
  return 0;
}
