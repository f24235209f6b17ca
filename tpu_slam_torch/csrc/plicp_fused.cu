// Batched PL-ICP, the whole match loop in one launch.
//
// Replaces: tpu_slam/ops/pallas/plicp_fused.py::plicp_match_fused (both
// Pallas variants, _make_kernel and _make_kernel_bcast). Plain PyTorch
// version: tpu_slam_torch/ops/plicp.py::plicp_match with the plain
// nearest_neighbor.
//
// What bounds it on the H100: not bytes. A pair's data (a few KB) is read
// once into shared memory. Each round is a chain of dependent block-wide
// steps: the nearest neighbour of every source among M targets, the two
// trimming quantiles of the gated |err|, and two Gauss-Newton steps, each
// ending in a sum over all sources and a 3x3 solve. So the time is the
// issue rate of the scans plus the latency of the per-round barrier
// chain, up to 10 rounds a pair.
//
// Design (ops/cuda/plicp_fused.py::plicp_geometry picks the shape): one
// block per scan pair, T threads, S sources a thread in registers (source
// s * T + t on thread t, so a warp holds 32 consecutive beams). Five
// barriers a round:
//   NN. The targets are staged once as float4 (x, y, valid flag, 0), and
//     the bounding box of each tile of 32 targets once. The search is the
//     exhaustive scan's: d = valid ? dx*dx + dy*dy : 1e12, target 0
//     first, then a strict < in index order, so ties go to the first
//     index. But a warp skips a tile when, for every lane, the tile's box
//     lies farther than the lane's least distance so far (seeded by the
//     8 targets around the lane's previous pick), with a 4e-6 relative
//     and 1e-30 absolute slack that covers the rounding of both
//     distances: a skipped tile holds no target at or below the minimum,
//     so the pick is the exhaustive scan's, bit for bit.
//   1-3. The exact trimming quantiles, by a radix select over the float
//     bits of the gated |err| (>= 0, so the bits sort as the values): a
//     1,024-bin histogram of 1/32-octave bins (shared atomics), every warp
//     then finds the bins that hold positions floor(q (cnt - 1)) (clamped
//     to N - 1) and the counts below them, the gated errors of those two
//     bins are gathered, and each member counts the members below and at
//     its value: the members whose [below, at) range holds the position
//     write the same value. That is the sort's order statistic, ties
//     included; a position past cnt gives 1e12, as the sort does.
//   4-5. The 11 + 9 normal-equation sums of the two GN steps: warp
//     shuffles give the sums of each group of 32 consecutive sources, one
//     partial a group in shared memory; then in each warp lane q adds the
//     q-th sum over the groups in source order and shuffles it to the
//     other lanes, and every thread solves the same 3x3 system, so all
//     threads carry the same pose without a block-wide broadcast. The
//     order of the sums is the same at every geometry (a block of one
//     source a thread sums in the same order), so the geometry never
//     moves a result.
// Each buffer is written and read between the same two barriers of a
// round, or alternates between rounds (the histogram), so no barrier
// trails a read. Each pair stops at its own epsilons. The TPU kernel's
// split-bf16 passes, one-hot gather matmuls, 22-step binary search for
// the quantiles, 128-padding and 8/16-pair blocking are MXU workarounds
// and are not carried over; no tensor cores either (an expanded |t|^2 -
// 2 w.t in TF32 would move the NN picks).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float BIG = 1e12f;
constexpr int MAX_THREADS = 1024;
constexpr int MAX_SOURCES = 8;  // sources a thread: template instances
constexpr int NV1 = 11;  // sums of the first GN step (H, b, inliers, err)
constexpr int NV2 = 9;   // sums of the second (H, b)
constexpr int TILE = 32;  // targets a bounding box: a warp, a lane a target
static_assert(TILE == 32, "a warp computes a tile's box, a lane a target");
constexpr int SEED = 8;  // targets around the last pick that seed the bound
constexpr float BOX_SLACK = 4e-6f;
// The radix select's bins: |err| >= 0, so its float bits sort as its
// values; bits >> 18 keeps the exponent and 5 mantissa bits (1/32 of an
// octave a bin), and the 1,024 bins cover [2^-31, 2): values below go to
// bin 0, above to bin 1,023. Any monotone map of the values is exact.
constexpr int BINS = 1024;
constexpr int BIN_SHIFT = 18;
constexpr int BIN_BASE = (127 - 31) << 5;
constexpr unsigned FULL = 0xffffffffu;

// The sums over each group of 32 consecutive sources: source s * T + t
// is lane t % 32 of group s * nw + t / 32. Lane 0 writes group g's NV
// sums of v to part[g * NV ...].
template <int S, int NV>
__device__ __forceinline__ void group_partials(float (&v)[S][NV],
                                               float* part, int nw) {
#pragma unroll
  for (int s = 0; s < S; ++s) {
#pragma unroll
    for (int q = 0; q < NV; ++q)
      for (int o = 16; o > 0; o >>= 1)
        v[s][q] += __shfl_xor_sync(FULL, v[s][q], o);
    if ((threadIdx.x & 31) == 0) {
#pragma unroll
      for (int q = 0; q < NV; ++q)
        part[(s * nw + (threadIdx.x >> 5)) * NV + q] = v[s][q];
    }
  }
}

// After the barrier: the block's totals, the ng groups' sums added in
// source order, so that the order is the same whatever the geometry. Lane
// q < NV adds value q over the groups; the totals are then broadcast.
template <int NV>
__device__ __forceinline__ void group_totals(float (&v)[NV],
                                             const float* part, int ng) {
  const int q = threadIdx.x & 31;
  float tot = 0.f;
  if (q < NV) {
    tot = part[q];
    for (int g = 1; g < ng; ++g) tot += part[g * NV + q];
  }
#pragma unroll
  for (int k = 0; k < NV; ++k) v[k] = __shfl_sync(FULL, tot, k);
}

// Closed-form symmetric 3x3 solve (cofactors), determinant guard 1e-20.
__device__ __forceinline__ void solve3(float h00, float h01, float h02,
                                       float h11, float h12, float h22,
                                       float b0, float b1, float b2,
                                       float* d) {
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

// The guarded step: zero unless 3 inliers and a finite solution.
__device__ __forceinline__ void guarded_step(const float (&v)[NV2],
                                             float ninl, float* d) {
  solve3(v[0], v[1], v[2], v[3], v[4], v[5], v[6], v[7], v[8], d);
  const bool ok = ninl >= 3.f && isfinite(d[0]) && isfinite(d[1]) &&
                  isfinite(d[2]);
  if (!ok) d[0] = d[1] = d[2] = 0.f;
}

// The NN's distance, as the exhaustive scan has always computed it.
__device__ __forceinline__ float dist2(float wx, float wy, float4 q) {
  const float dx = wx - q.x, dy = wy - q.y;
  return q.z > 0.f ? dx * dx + dy * dy : BIG;
}

// The histogram bin of an |err| (>= 0), monotone in the value.
__device__ __forceinline__ int bin_of(float e) {
  return min(max((int)(__float_as_uint(e) >> BIN_SHIFT) - BIN_BASE, 0),
             BINS - 1);
}

// Every lane of the warp: for positions r[0] and r[1] of the sorted
// gated errors, the bin that holds each and the count below that bin;
// (-1, 0) where r >= cnt. excl and incl are the lane's exclusive and
// inclusive prefix over its 32 bins (lane l holds bins 32 l ... 32 l +
// 31). The two searches are interleaved.
__device__ __forceinline__ void find_bins(const int* h, const int (&r)[2],
                                          int cnt, int excl, int incl,
                                          int (&bin)[2], int (&below)[2]) {
  const int lane = threadIdx.x & 31;
  int L[2], c[2], run[2];
#pragma unroll
  for (int q = 0; q < 2; ++q) {
    // r >= cnt: no lane holds it; L = 0 keeps the reads in range
    L[q] = max(__ffs(__ballot_sync(FULL, excl <= r[q] && r[q] < incl)) - 1,
               0);
    c[q] = h[32 * L[q] + lane];  // lane k: bin 32 L + k
    run[q] = c[q];
  }
  for (int o = 1; o < 32; o <<= 1) {
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const int u = __shfl_up_sync(FULL, run[q], o);
      if (lane >= o) run[q] += u;
    }
  }
#pragma unroll
  for (int q = 0; q < 2; ++q) {
    const int lo = __shfl_sync(FULL, excl, L[q]) + run[q] - c[q];
    const int k =
        __ffs(__ballot_sync(FULL, lo <= r[q] && r[q] < lo + c[q])) - 1;
    bin[q] = r[q] < cnt ? 32 * L[q] + k : -1;
    below[q] = __shfl_sync(FULL, lo, max(k, 0));
  }
}

// Warp-aggregated: the lanes with `take` get consecutive slots from the
// counter; returns the lane's slot (undefined where !take).
__device__ __forceinline__ int warp_slot(bool take, int* counter) {
  const unsigned bal = __ballot_sync(FULL, take);
  if (!bal) return 0;
  const int lane = threadIdx.x & 31, lead = __ffs(bal) - 1;
  int base = 0;
  if (lane == lead) base = atomicAdd(counter, __popc(bal));
  base = __shfl_sync(FULL, base, lead);
  return base + __popc(bal & ((1u << lane) - 1u));
}

// Dynamic shared memory (plicp_fused.py::smem_bytes): M float4 targets,
// nb float4 tile boxes (x min, y min, x max, y max of the valid targets),
// 2 x BINS histogram counts, nb tile flags (1e12 where the tile holds an
// invalid target, else +inf), 2 x N gathered errors, the two GN steps'
// per-group partials (S nw x 11, S nw x 9), two quantile slots and two
// gathering counters.
template <int S>
__global__ void __launch_bounds__(MAX_THREADS / S) plicp_fused_kernel(
    const float* __restrict__ src, const uint8_t* __restrict__ src_valid,
    const float* __restrict__ tgt, const uint8_t* __restrict__ tgt_valid,
    const float* __restrict__ init, float* __restrict__ pose_out,
    float* __restrict__ stats_out, float* __restrict__ h_out, int N, int M,
    int rounds, float max_d2, float eps_xy, float eps_th, float q_perc,
    float q_adap, float adap_mult) {
  extern __shared__ float4 smem4[];
  const int T = blockDim.x, t = threadIdx.x, nw = T >> 5, lane = t & 31;
  const int nb = (M + TILE - 1) / TILE, ng = (N + 31) / 32;
  float4* tg = smem4;
  float4* box = tg + M;
  int* hist = reinterpret_cast<int*>(box + nb);
  float* tinv = reinterpret_cast<float*>(hist + 2 * BINS);
  float* list = tinv + nb;  // 2 x N
  float* part1 = list + 2 * N;
  float* part2 = part1 + S * nw * NV1;
  float* qslot = part2 + S * nw * NV2;
  int* cq = reinterpret_cast<int*>(qslot + 2);

  const int b = blockIdx.x;
  const size_t tb = (size_t)b * M;
  // invalid or non-finite coordinates are zeroed; validity is kept as given
  for (int j = t; j < M; j += T) {
    const bool v = tgt_valid[tb + j] != 0;
    const float x = tgt[2 * (tb + j)], y = tgt[2 * (tb + j) + 1];
    tg[j] = make_float4((v && isfinite(x)) ? x : 0.f,
                        (v && isfinite(y)) ? y : 0.f, v ? 1.f : 0.f, 0.f);
  }
  for (int tile = t >> 5; tile < nb; tile += nw) {  // a warp a tile
    const int j = tile * TILE + lane;
    bool v = false;
    float x = 0.f, y = 0.f;
    if (j < M) {
      v = tgt_valid[tb + j] != 0;
      x = tgt[2 * (tb + j)];
      y = tgt[2 * (tb + j) + 1];
      x = (v && isfinite(x)) ? x : 0.f;
      y = (v && isfinite(y)) ? y : 0.f;
    }
    const float inf = __int_as_float(0x7f800000);
    float x0 = v ? x : inf, y0 = v ? y : inf, x1 = v ? x : -inf,
          y1 = v ? y : -inf;
    for (int o = 16; o > 0; o >>= 1) {
      x0 = fminf(x0, __shfl_xor_sync(FULL, x0, o));
      y0 = fminf(y0, __shfl_xor_sync(FULL, y0, o));
      x1 = fmaxf(x1, __shfl_xor_sync(FULL, x1, o));
      y1 = fmaxf(y1, __shfl_xor_sync(FULL, y1, o));
    }
    const bool any_invalid = __any_sync(FULL, j < M && !v);
    if (lane == 0) {
      box[tile] = make_float4(x0, y0, x1, y1);
      tinv[tile] = any_invalid ? BIG : inf;
    }
  }
  for (int k = t; k < 2 * BINS; k += T) hist[k] = 0;
  bool sv[S];
  float sx[S], sy[S];
  int seed[S];  // the last pick of each source: where its bound starts
#pragma unroll
  for (int s = 0; s < S; ++s) {
    const int i = s * T + t;
    sv[s] = false;
    sx[s] = sy[s] = 0.f;
    seed[s] = (int)(((long long)min(i, N - 1) * M) / N);
    if (i < N) {
      const size_t sb = (size_t)b * N + i;
      sv[s] = src_valid[sb] != 0;
      const float x = src[2 * sb], y = src[2 * sb + 1];
      sx[s] = (sv[s] && isfinite(x)) ? x : 0.f;
      sy[s] = (sv[s] && isfinite(y)) ? y : 0.f;
    }
  }
  float px = init[3 * b], py = init[3 * b + 1], pth = init[3 * b + 2];
  float err_o = 0.f, ninl_o = 0.f;
  float h_o[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  bool conv = false;
  __syncthreads();

  for (int rnd = 0; rnd < rounds && !conv; ++rnd) {
    int* h = hist + BINS * (rnd & 1);
    // the other histogram, last read two rounds' barriers ago
    for (int k = t; k < BINS; k += T) hist[BINS * ((rnd + 1) & 1) + k] = 0;
    if (t < 2) cq[t] = 0;

    // --- correspondences at the current pose
    float c = cosf(pth), sn = sinf(pth);
    bool gate[S];
    float wx[S], wy[S], nx[S], ny[S], q1x[S], q1y[S], resid[S], err[S];
#pragma unroll
    for (int s = 0; s < S; ++s) {
      wx[s] = c * sx[s] - sn * sy[s] + px;
      wy[s] = sn * sx[s] + c * sy[s] + py;
      float best = dist2(wx[s], wy[s], tg[0]);
      int j1 = 0;
      const bool need = s * T + t < N && sv[s];
      const int j0 = min(max(seed[s] - SEED / 2, 0), max(M - SEED, 0));
      float bound = best;
      for (int k = 0; k < SEED && j0 + k < M; ++k)
        bound = fminf(bound, dist2(wx[s], wy[s], tg[j0 + k]));
      for (int tile = 0; tile < nb; ++tile) {
        const float4 bx = box[tile];
        const float gx = fmaxf(fmaxf(bx.x - wx[s], wx[s] - bx.z), 0.f);
        const float gy = fmaxf(fmaxf(bx.y - wy[s], wy[s] - bx.w), 0.f);
        const float lb = fminf(gx * gx + gy * gy, tinv[tile]);
        if (!__any_sync(FULL, need && lb * (1.f - BOX_SLACK) <=
                                          fminf(bound, best) + 1e-30f))
          continue;  // no lane has a target here at or below its minimum
        const int end = min(tile * TILE + TILE, M);
        for (int j = max(tile * TILE, 1); j < end; ++j) {
          const float d = dist2(wx[s], wy[s], tg[j]);
          if (d < best) {
            best = d;
            j1 = j;
          }
        }
      }
      seed[s] = j1;
      const float4 t1 = tg[j1];
      q1x[s] = t1.x;
      q1y[s] = t1.y;
      const int lo = max(j1 - 1, 0), hi = min(j1 + 1, M - 1);
      const float4 tl = tg[lo], th = tg[hi];
      float dlo = BIG, dhi = BIG;
      if (tl.z > 0.f && lo != j1) {
        const float dx = wx[s] - tl.x, dy = wy[s] - tl.y;
        dlo = dx * dx + dy * dy;
      }
      if (th.z > 0.f && hi != j1) {
        const float dx = wx[s] - th.x, dy = wy[s] - th.y;
        dhi = dx * dx + dy * dy;
      }
      const float4 t2 = dlo <= dhi ? tl : th;
      const float tgx = t2.x - q1x[s], tgy = t2.y - q1y[s];
      const float tlen = sqrtf(tgx * tgx + tgy * tgy);
      gate[s] = s * T + t < N && sv[s] && best < max_d2 && t1.z > 0.f &&
                tlen > 1e-9f && t2.z > 0.f;
      const float tln = fmaxf(tlen, 1e-9f);
      nx[s] = -(tgy / tln);
      ny[s] = tgx / tln;
      resid[s] = nx[s] * (wx[s] - q1x[s]) + ny[s] * (wy[s] - q1y[s]);
      err[s] = fabsf(resid[s]);
      // one atomic for each bin the warp's lanes hit
      const int bin = gate[s] ? bin_of(err[s]) : -1;
      const unsigned peers = __match_any_sync(FULL, bin);
      if (bin >= 0 && lane == __ffs(peers) - 1)
        atomicAdd(&h[bin], __popc(peers));
    }
    __syncthreads();  // 1: the histogram

    // --- trimming: the two exact masked quantiles
    int pp, pa, bin2[2], below2[2];
    // every warp: the prefix over the bins, lane l holding 32 of them,
    // its 8 int4 loads in an order rotated by the lane so that 8 lanes
    // of a load phase hit 8 distinct 16-byte bank groups
    const int4* h4 = reinterpret_cast<const int4*>(h) + 8 * lane;
    int mine = 0;
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const int4 v = h4[(k + lane) & 7];
      mine += v.x + v.y + v.z + v.w;
    }
    int incl = mine;
    for (int o = 1; o < 32; o <<= 1) {
      const int u = __shfl_up_sync(FULL, incl, o);
      if (lane >= o) incl += u;
    }
    const int cnt = __shfl_sync(FULL, incl, 31);
    const float cnt1 = fmaxf((float)cnt - 1.f, 0.f);
    pp = min(max((int)floorf(q_perc * cnt1), 0), N - 1);
    pa = min(max((int)floorf(q_adap * cnt1), 0), N - 1);
    const int rr[2] = {pp, pa};
    find_bins(h, rr, cnt, incl - mine, incl, bin2, below2);
#pragma unroll
    for (int s = 0; s < S; ++s) {
      const int bin = bin_of(err[s]);
      const bool in_p = gate[s] && bin == bin2[0];
      const bool in_a = gate[s] && bin == bin2[1];
      const int sp = warp_slot(in_p, &cq[0]), sa = warp_slot(in_a, &cq[1]);
      if (in_p) list[sp] = err[s];
      if (in_a) list[N + sa] = err[s];
    }
    __syncthreads();  // 2: the two bins' errors gathered
#pragma unroll
    for (int s = 0; s < S; ++s) {
      if (!gate[s]) continue;
      const int bin = bin_of(err[s]);
      for (int q = 0; q < 2; ++q) {
        if (bin != bin2[q]) continue;
        const float* l = list + q * N;
        const int n = h[bin], r = (q ? pa : pp) - below2[q];
        int lt = 0, le = 0;
        for (int k = 0; k < n; ++k) {
          lt += l[k] < err[s];
          le += l[k] <= err[s];
        }
        if (lt <= r && r < le) qslot[q] = err[s];
      }
    }
    __syncthreads();  // 3: the two quantiles
    const float thr = fminf(pp < cnt ? qslot[0] : BIG,
                            fmaxf(adap_mult * (pa < cnt ? qslot[1] : BIG),
                                  1e-6f));

    // --- first Gauss-Newton step on the frozen correspondences
    float w[S], v1[NV1];
    {
      float c1[S][NV1];
#pragma unroll
      for (int s = 0; s < S; ++s) {
        w[s] = (gate[s] && err[s] <= thr + 1e-12f) ? 1.f : 0.f;
        const float jth = nx[s] * (-(wy[s] - py)) + ny[s] * (wx[s] - px);
        const float ws = w[s];
        const float r[NV1] = {
            ws * nx[s] * nx[s], ws * nx[s] * ny[s], ws * nx[s] * jth,
            ws * ny[s] * ny[s], ws * ny[s] * jth,   ws * jth * jth,
            -(ws * nx[s] * resid[s]), -(ws * ny[s] * resid[s]),
            -(ws * jth * resid[s]), ws, ws * err[s]};
#pragma unroll
        for (int q = 0; q < NV1; ++q) c1[s][q] = r[q];
      }
      group_partials<S, NV1>(c1, part1, nw);
    }
    __syncthreads();  // 4: the first step's partials
    group_totals<NV1>(v1, part1, ng);
    float d[3];
    {
      const float hh[NV2] = {v1[0] + 1e-9f, v1[1], v1[2], v1[3] + 1e-9f,
                             v1[4], v1[5] + 1e-9f, v1[6], v1[7], v1[8]};
      guarded_step(hh, v1[9], d);
    }
    const float px1 = px + d[0], py1 = py + d[1];
    const float pt1 = atan2f(sinf(pth + d[2]), cosf(pth + d[2]));

    // --- second step from the updated pose, same correspondences
    c = cosf(pt1);
    sn = sinf(pt1);
    float v2[NV2];
    {
      float c2[S][NV2];
#pragma unroll
      for (int s = 0; s < S; ++s) {
        const float w1x = c * sx[s] - sn * sy[s] + px1;
        const float w1y = sn * sx[s] + c * sy[s] + py1;
        const float r1 = nx[s] * (w1x - q1x[s]) + ny[s] * (w1y - q1y[s]);
        const float jth = nx[s] * (-(w1y - py1)) + ny[s] * (w1x - px1);
        const float ws = w[s];
        const float r[NV2] = {
            ws * nx[s] * nx[s], ws * nx[s] * ny[s], ws * nx[s] * jth,
            ws * ny[s] * ny[s], ws * ny[s] * jth,   ws * jth * jth,
            -(ws * nx[s] * r1), -(ws * ny[s] * r1), -(ws * jth * r1)};
#pragma unroll
        for (int q = 0; q < NV2; ++q) c2[s][q] = r[q];
      }
      group_partials<S, NV2>(c2, part2, nw);
    }
    __syncthreads();  // 5: the second step's partials
    group_totals<NV2>(v2, part2, ng);
    v2[0] += 1e-9f;
    v2[3] += 1e-9f;
    v2[5] += 1e-9f;
    float e[3];
    guarded_step(v2, v1[9], e);
    px = px1 + e[0];
    py = py1 + e[1];
    pth = atan2f(sinf(pt1 + e[2]), cosf(pt1 + e[2]));
    err_o = v1[10] / fmaxf(v1[9], 1.f);
    ninl_o = v1[9];
#pragma unroll
    for (int k = 0; k < 6; ++k) h_o[k] = v2[k];
    conv = fabsf(d[0] + e[0]) < eps_xy && fabsf(d[1] + e[1]) < eps_xy &&
           fabsf(d[2] + e[2]) < eps_th;
  }

  if (t == 0) {
    pose_out[3 * b] = px;
    pose_out[3 * b + 1] = py;
    pose_out[3 * b + 2] = pth;
    stats_out[4 * b] = err_o;
    stats_out[4 * b + 1] = ninl_o;
    stats_out[4 * b + 2] = conv ? 1.f : 0.f;
    stats_out[4 * b + 3] = 0.f;
    float* hq = h_out + 9 * (size_t)b;
    hq[0] = h_o[0]; hq[1] = h_o[1]; hq[2] = h_o[2];
    hq[3] = h_o[1]; hq[4] = h_o[3]; hq[5] = h_o[4];
    hq[6] = h_o[2]; hq[7] = h_o[4]; hq[8] = h_o[5];
  }
}

template <int S>
int launch(const void* src, const void* src_valid, const void* tgt,
           const void* tgt_valid, const void* init, void* pose, void* stats,
           void* h, int B, int N, int M, int rounds, float max_d2,
           float eps_xy, float eps_th, float q_perc, float q_adap,
           float adap_mult, int threads, int smem, cudaStream_t stream) {
  if (threads > MAX_THREADS / S) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        plicp_fused_kernel<S>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (e != cudaSuccess) return (int)e;
  }
  plicp_fused_kernel<S><<<B, threads, smem, stream>>>(
      (const float*)src, (const uint8_t*)src_valid, (const float*)tgt,
      (const uint8_t*)tgt_valid, (const float*)init, (float*)pose,
      (float*)stats, (float*)h, N, M, rounds, max_d2, eps_xy, eps_th, q_perc,
      q_adap, adap_mult);
  return (int)cudaGetLastError();
}

}  // namespace

// src (B, N, 2) f32, src_valid (B, N) bool, tgt (B, M, 2) f32, tgt_valid
// (B, M) bool, init (B, 3) f32; pose (B, 3), stats (B, 4) and h (B, 9)
// f32 out; all contiguous on one device. `threads` a block, `spt` sources
// a thread and `smem` bytes come from
// ops/cuda/plicp_fused.py::plicp_geometry. Returns a cudaError_t (0 on
// success; non-zero when the geometry does not cover the sources or the
// shared memory does not hold the layout).
extern "C" int plicp_fused_launch(
    const void* src, const void* src_valid, const void* tgt,
    const void* tgt_valid, const void* init, void* pose, void* stats, void* h,
    int B, int N, int M, int rounds, float max_d2, float eps_xy, float eps_th,
    float q_perc, float q_adap, float adap_mult, int threads, int spt,
    int smem, void* stream) {
  const size_t nw = threads / 32, nb = (M + TILE - 1) / TILE;
  if (B < 1 || N < 1 || M < 1 || threads < 32 || threads % 32 ||
      spt < 1 || spt > MAX_SOURCES || threads * spt < N ||
      (size_t)smem < 16 * ((size_t)M + nb) +
                         4 * (2 * BINS + nb + 2 * (size_t)N +
                              spt * nw * (NV1 + NV2) + 4))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
#define PLICP_CASE(S)                                                       \
  case S:                                                                   \
    return launch<S>(src, src_valid, tgt, tgt_valid, init, pose, stats, h,  \
                     B, N, M, rounds, max_d2, eps_xy, eps_th, q_perc,       \
                     q_adap, adap_mult, threads, smem, st);
  switch (spt) {
    PLICP_CASE(1) PLICP_CASE(2) PLICP_CASE(3) PLICP_CASE(4)
    PLICP_CASE(5) PLICP_CASE(6) PLICP_CASE(7) PLICP_CASE(8)
  }
#undef PLICP_CASE
  return (int)cudaErrorInvalidValue;
}
