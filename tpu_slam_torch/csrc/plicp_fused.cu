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
// trails a read. Each pair stops at its own epsilons.
// Any N and M, one code path. The first pass (T x S sources, at most
// 1,024, against chunk 0 of the targets, mc of them in shared memory) is
// the kernel as it was without chunks, its lists and partials in shared
// memory. Sources past it (source (c * S + s) * T + t) and targets past
// chunk 0 (staged chunk after chunk in index order, two barriers around
// each restage) are taken by functions that are not inlined (rest_*),
// each source's pick, running minimum and correspondence in device
// scratch, written and read again by the same thread. Where the targets
// take chunks, rest_nn scans every source over all of them with the first
// pass's strict <, so the pick is the exhaustive scan's; target 0 and the
// seed window come from chunk 0 (any target's distance bounds the
// minimum), j1 +- 1 from where they live. Where the 2 N gathered errors
// and the partials of the C S nw groups do not fit beside the targets,
// they are in device scratch and the rest_* functions take the first
// pass's sources too; the groups stay in source order, so no chunking
// moves a sum. The first pass's round state is written to the scratch
// once and read back after each call, so that none of it lives across a
// call. The calls still cost the one-chunk launch registers (the calling
// convention): the S = 2 instance is held to PAIR_THREADS threads and 2
// blocks an SM, 80 registers, where it spills little.
// The TPU kernel's split-bf16 passes, one-hot gather matmuls,
// 22-step binary search for the quantiles, 128-padding and 8/16-pair
// blocking are MXU workarounds and are not carried over; no tensor cores
// either (an expanded |t|^2 - 2 w.t in TF32 would move the NN picks).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float BIG = 1e12f;
constexpr int MAX_THREADS = 1024;
constexpr int MAX_SOURCES = 8;  // sources a thread: template instances
// The S = 2 instance (the batches that fill the card) takes at most
// PAIR_THREADS threads and 2 blocks an SM: 80 registers a thread, enough
// for its first pass beside the chunks' calls (a pair of 360 beams runs
// 192 threads, 4 blocks an SM).
constexpr int PAIR_THREADS = 384;
__host__ __device__ constexpr int max_threads(int S) {
  return S == 2 ? PAIR_THREADS : MAX_THREADS / S;
}
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

// A source's point: the invalid or non-finite coordinates zeroed, the
// validity kept as given; a slot past N is an invalid source.
struct Source {
  bool v;
  float x, y;
};

__device__ __forceinline__ Source load_source(const float* __restrict__ src,
                                              const uint8_t* __restrict__ sv,
                                              size_t sb, int i, int N) {
  Source p = {false, 0.f, 0.f};
  if (i < N) {
    p.v = sv[sb + i] != 0;
    const float x = src[2 * (sb + i)], y = src[2 * (sb + i) + 1];
    p.x = (p.v && isfinite(x)) ? x : 0.f;
    p.y = (p.v && isfinite(y)) ? y : 0.f;
  }
  return p;
}

// Target j as it is staged: (x, y, valid flag, 0), the invalid or
// non-finite coordinates zeroed.
__device__ __forceinline__ float4 load_target(const float* __restrict__ tgt,
                                              const uint8_t* __restrict__ tv,
                                              size_t tb, int j) {
  const bool v = tv[tb + j] != 0;
  const float x = tgt[2 * (tb + j)], y = tgt[2 * (tb + j) + 1];
  return make_float4((v && isfinite(x)) ? x : 0.f,
                     (v && isfinite(y)) ? y : 0.f, v ? 1.f : 0.f, 0.f);
}

// The staged chunk of targets [k0, k0 + m) and a box and a flag for each
// tile of TILE of them, written by the whole block.
struct Targets {
  const float* tgt;
  const uint8_t* tv;
  size_t tb;  // the pair's first target
  float4* tg;  // m staged targets
  float4* box;
  float* tinv;
  int k0, m;

  // target j of the pair, from the staged chunk where it lies there,
  // else from device memory
  __device__ __forceinline__ float4 at(int j) const {
    return (unsigned)(j - k0) < (unsigned)m ? tg[j - k0]
                                            : load_target(tgt, tv, tb, j);
  }

  __device__ void stage(int first, int count) {
    k0 = first;
    m = count;
    const int T = blockDim.x, t = threadIdx.x, nw = T >> 5, lane = t & 31;
    for (int j = t; j < m; j += T) tg[j] = load_target(tgt, tv, tb, k0 + j);
    const int nb = (m + TILE - 1) / TILE;
    for (int tile = t >> 5; tile < nb; tile += nw) {  // a warp a tile
      const int j = tile * TILE + lane;
      const float4 q =
          j < m ? load_target(tgt, tv, tb, k0 + j) : make_float4(0, 0, 0, 0);
      const bool v = q.z > 0.f;
      const float inf = __int_as_float(0x7f800000);
      float x0 = v ? q.x : inf, y0 = v ? q.y : inf, x1 = v ? q.x : -inf,
            y1 = v ? q.y : -inf;
      for (int o = 16; o > 0; o >>= 1) {
        x0 = fminf(x0, __shfl_xor_sync(FULL, x0, o));
        y0 = fminf(y0, __shfl_xor_sync(FULL, y0, o));
        x1 = fmaxf(x1, __shfl_xor_sync(FULL, x1, o));
        y1 = fmaxf(y1, __shfl_xor_sync(FULL, y1, o));
      }
      const bool any_invalid = __any_sync(FULL, j < m && !v);
      if (lane == 0) {
        box[tile] = make_float4(x0, y0, x1, y1);
        tinv[tile] = any_invalid ? BIG : inf;
      }
    }
  }
};

// A source's running nearest neighbour before the scan, chunk 0 staged:
// target 0, and the bound from it and the SEED targets of chunk 0 around
// the source's last pick (any target's distance bounds the minimum, so
// the pruning stays exact wherever the pick lies).
__device__ __forceinline__ void nn_start(const Targets& tg, float wx,
                                         float wy, int seed, float& best,
                                         int& j1, float& bound) {
  best = dist2(wx, wy, tg.tg[0]);
  j1 = 0;
  const int j0 = min(max(seed - SEED / 2, 0), max(tg.m - SEED, 0));
  bound = best;
  for (int k = 0; k < SEED && j0 + k < tg.m; ++k)
    bound = fminf(bound, dist2(wx, wy, tg.tg[j0 + k]));
}

// The staged chunk's targets for one source of every lane of the warp:
// tiles in index order, a tile skipped when no lane needs it, a strict <
// within, so across the chunks the first index of the minimum wins.
__device__ __forceinline__ void nn_scan(const Targets& tg, float wx,
                                        float wy, bool need, float bound,
                                        float& best, int& j1) {
  const int nb = (tg.m + TILE - 1) / TILE;
  const int first = tg.k0 == 0 ? 1 : 0;  // target 0 started the scan
  for (int tile = 0; tile < nb; ++tile) {
    const float4 bx = tg.box[tile];
    const float gx = fmaxf(fmaxf(bx.x - wx, wx - bx.z), 0.f);
    const float gy = fmaxf(fmaxf(bx.y - wy, wy - bx.w), 0.f);
    const float lb = fminf(gx * gx + gy * gy, tg.tinv[tile]);
    if (!__any_sync(FULL, need && lb * (1.f - BOX_SLACK) <=
                                      fminf(bound, best) + 1e-30f))
      continue;  // no lane has a target here at or below its minimum
    const int end = min(tile * TILE + TILE, tg.m);
    for (int j = max(tile * TILE, first); j < end; ++j) {
      const float d = dist2(wx, wy, tg.tg[j]);
      if (d < best) {
        best = d;
        j1 = tg.k0 + j;
      }
    }
  }
}

// A source's correspondence at its pick j1: the nearer valid neighbour of
// j1 in index order, the normal of the segment, the residual and the gate.
struct Corr {
  float q1x, q1y, nx, ny, resid;
  bool gate;
};

__device__ __forceinline__ Corr correspond(const Targets& tg, float wx,
                                           float wy, bool need, float best,
                                           int j1, int M, float max_d2) {
  Corr r;
  const float4 t1 = tg.at(j1);
  r.q1x = t1.x;
  r.q1y = t1.y;
  const int lo = max(j1 - 1, 0), hi = min(j1 + 1, M - 1);
  const float4 tl = tg.at(lo), th = tg.at(hi);
  float dlo = BIG, dhi = BIG;
  if (tl.z > 0.f && lo != j1) {
    const float dx = wx - tl.x, dy = wy - tl.y;
    dlo = dx * dx + dy * dy;
  }
  if (th.z > 0.f && hi != j1) {
    const float dx = wx - th.x, dy = wy - th.y;
    dhi = dx * dx + dy * dy;
  }
  const float4 t2 = dlo <= dhi ? tl : th;
  const float tgx = t2.x - r.q1x, tgy = t2.y - r.q1y;
  const float tlen = sqrtf(tgx * tgx + tgy * tgy);
  r.gate = need && best < max_d2 && t1.z > 0.f && tlen > 1e-9f && t2.z > 0.f;
  const float tln = fmaxf(tlen, 1e-9f);
  r.nx = -(tgy / tln);
  r.ny = tgx / tln;
  r.resid = r.nx * (wx - r.q1x) + r.ny * (wy - r.q1y);
  return r;
}

// One atomic for each histogram bin the warp's lanes hit.
__device__ __forceinline__ void count_bin(int* h, bool gate, float err) {
  const int bin = gate ? bin_of(err) : -1;
  const unsigned peers = __match_any_sync(FULL, bin);
  if (bin >= 0 && (threadIdx.x & 31) == __ffs(peers) - 1)
    atomicAdd(&h[bin], __popc(peers));
}

// Gathers a gated error into the list of each of the two bins it lies in.
__device__ __forceinline__ void gather(bool gate, float err,
                                       const int (&bin2)[2], int* cq,
                                       float* list, int N) {
  const int bin = bin_of(err);
  const bool in_p = gate && bin == bin2[0];
  const bool in_a = gate && bin == bin2[1];
  const int sp = warp_slot(in_p, &cq[0]), sa = warp_slot(in_a, &cq[1]);
  if (in_p) list[sp] = err;
  if (in_a) list[N + sa] = err;
}

// A gathered error whose [below, at) range among its bin's members holds
// the quantile's position writes the quantile.
__device__ __forceinline__ void rank(bool gate, float err,
                                     const int (&bin2)[2],
                                     const int (&below2)[2], const int* h,
                                     const float* list, int pp, int pa,
                                     float* qslot, int N) {
  if (!gate) return;
  const int bin = bin_of(err);
  for (int q = 0; q < 2; ++q) {
    if (bin != bin2[q]) continue;
    const float* l = list + q * N;
    const int n = h[bin], r = (q ? pa : pp) - below2[q];
    int lt = 0, le = 0;
    for (int k = 0; k < n; ++k) {
      lt += l[k] < err;
      le += l[k] <= err;
    }
    if (lt <= r && r < le) qslot[q] = err;
  }
}

// The GN steps' terms of one source, out[0 .. NV) from the weight ws, the
// normal (nx, ny) and the point: the first step's at the round's pose
// (px, py), with its residual and |err|; the second's from the updated
// pose (c, sn, px1, py1) and the segment's first target (q1x, q1y). They
// are macros, not functions: written out where they are used, nvcc
// contracts their products into the sums that follow as the kernel always
// has, and an inlined function contracts them otherwise, which moves the
// low bits of every pose.
#define STEP1_TERMS(out, ws, nx, ny, wx, wy, resid, err)                     \
  {                                                                          \
    const float jth_ = (nx) * (-((wy) - py)) + (ny) * ((wx) - px);           \
    const float v_[NV1] = {                                                  \
        (ws) * (nx) * (nx), (ws) * (nx) * (ny), (ws) * (nx) * jth_,          \
        (ws) * (ny) * (ny), (ws) * (ny) * jth_, (ws) * jth_ * jth_,          \
        -((ws) * (nx) * (resid)), -((ws) * (ny) * (resid)),                  \
        -((ws) * jth_ * (resid)), (ws), (ws) * (err)};                       \
    _Pragma("unroll") for (int q = 0; q < NV1; ++q) (out)[q] = v_[q];        \
  }

#define STEP2_TERMS(out, ws, nx, ny, q1x, q1y, sx, sy)                       \
  {                                                                          \
    const float w1x_ = c * (sx) - sn * (sy) + px1;                           \
    const float w1y_ = sn * (sx) + c * (sy) + py1;                           \
    const float r1_ = (nx) * (w1x_ - (q1x)) + (ny) * (w1y_ - (q1y));         \
    const float jth_ = (nx) * (-(w1y_ - py1)) + (ny) * (w1x_ - px1);         \
    const float v_[NV2] = {                                                  \
        (ws) * (nx) * (nx), (ws) * (nx) * (ny), (ws) * (nx) * jth_,          \
        (ws) * (ny) * (ny), (ws) * (ny) * jth_, (ws) * jth_ * jth_,          \
        -((ws) * (nx) * r1_), -((ws) * (ny) * r1_), -((ws) * jth_ * r1_)};   \
    _Pragma("unroll") for (int q = 0; q < NV2; ++q) (out)[q] = v_[q];        \
  }

// The kernel's arguments that the chunks' functions take, as they were
// given: each function derives its pointers itself from them and the
// block index, so that no pointer of the chunks lives across the first
// pass's loops. `first` = S T, the first source past the first pass.
struct Args {
  const float* src;
  const uint8_t* sv;
  const float* tgt;
  const uint8_t* tv;
  float* scratch;
  int stride, N, M, mc, lists_global, first;

  // device scratch of the pair: 2 float4 a source (q1x, q1y, nx, ny | wx,
  // wy, resid, gate; best, bound, -, - between target chunks), then an
  // int pick a source, then the lists where they are not in shared memory
  __device__ __forceinline__ float4* rec() const {
    return reinterpret_cast<float4*>(scratch + (size_t)blockIdx.x * stride);
  }
  __device__ __forceinline__ int* pick() const {
    return reinterpret_cast<int*>(rec() + 2 * (size_t)N);
  }
  __device__ __forceinline__ float* lists() const {
    return reinterpret_cast<float*>(pick() + N);
  }
};

// The shared layout (plicp_fused.py::smem_bytes): mc float4 staged
// targets, nb float4 tile boxes (x min, y min, x max, y max of the valid
// targets), 2 x BINS histogram counts, nb tile flags (1e12 where the tile
// holds an invalid target, else +inf), two quantile slots, two gathering
// counters, then, unless `lists_global`, the lists: 2 x N gathered errors
// and the two GN steps' per-group partials (G x 11, G x 9, G = C S nw
// groups of 32 sources). `lists_global` puts the lists after the picks
// in device scratch.
struct Layout {
  float4 *tg, *box;
  int* hist;
  float *tinv, *qslot;
  int* cq;
  float* list;

  __device__ __forceinline__ Layout(int mc, bool lists_global,
                                    float* glist) {
    extern __shared__ float4 smem4[];
    const int nb = (mc + TILE - 1) / TILE;
    tg = smem4;
    box = tg + mc;
    hist = reinterpret_cast<int*>(box + nb);
    tinv = reinterpret_cast<float*>(hist + 2 * BINS);
    qslot = tinv + nb;
    cq = reinterpret_cast<int*>(qslot + 2);
    list = lists_global ? glist : reinterpret_cast<float*>(cq + 2);
  }
  __device__ __forceinline__ explicit Layout(const Args& a)
      : Layout(a.mc, a.lists_global, a.lists()) {}
};

// The nearest neighbours of the sources that the first pass does not
// finish, over every chunk of targets in index order (two barriers around
// each restage), with their correspondences and histogram bins: the
// sources past the first pass, and all of them where the targets take
// chunks (the first pass then scans none). Chunk 0 is staged on entry and
// again on exit, after a barrier, for the next round.
__device__ __noinline__ void rest_nn(const Args a, float c, float sn,
                                     float px, float py, float max_d2,
                                     int hsel) {
  const Layout L(a);
  const int t = threadIdx.x, T = blockDim.x;
  const int KC = (a.M + a.mc - 1) / a.mc;
  const size_t sb = (size_t)blockIdx.x * a.N;
  float4* rec = a.rec();
  int* pick = a.pick();
  int* h = L.hist + BINS * hsel;
  Targets tg = {a.tgt,  a.tv,  (size_t)blockIdx.x * a.M, L.tg, L.box, L.tinv,
                0,      min(a.mc, a.M)};
  for (int kc = 0; kc < KC; ++kc) {
    if (kc > 0) {
      __syncthreads();  // the previous chunk's scans are done
      tg.stage(kc * a.mc, min(a.mc, a.M - kc * a.mc));
      __syncthreads();
    }
    const bool last = kc == KC - 1;
    // the trip count is the block's, so that the warps' votes see every
    // lane; a slot past N copies source N - 1 and writes nothing
    for (int i = (KC > 1 ? 0 : a.first) + t; i - t < a.N; i += T) {
      const int ic = min(i, a.N - 1);
      const Source p = load_source(a.src, a.sv, sb, i, a.N);
      const float ux = c * p.x - sn * p.y + px;
      const float uy = sn * p.x + c * p.y + py;
      float bst, bnd;
      int j;
      if (kc == 0) {
        nn_start(tg, ux, uy, pick[ic], bst, j, bnd);
      } else {
        const float4 r = rec[2 * (size_t)ic + 1];
        bst = r.x;
        bnd = r.y;
        j = pick[ic];
      }
      nn_scan(tg, ux, uy, i < a.N && p.v, bnd, bst, j);
      if (!last) {
        if (i < a.N) {
          pick[i] = j;
          rec[2 * (size_t)i + 1] = make_float4(bst, bnd, 0.f, 0.f);
        }
        continue;
      }
      const Corr r = correspond(tg, ux, uy, i < a.N && p.v, bst, j, a.M,
                                max_d2);
      if (i < a.N) {
        pick[i] = j;
        rec[2 * (size_t)i] = make_float4(r.q1x, r.q1y, r.nx, r.ny);
        rec[2 * (size_t)i + 1] =
            make_float4(ux, uy, r.resid, r.gate ? 1.f : 0.f);
      }
      count_bin(h, r.gate, fabsf(r.resid));
    }
  }
  if (KC > 1) {
    __syncthreads();  // the last chunk's reads are done
    tg.stage(0, min(a.mc, a.M));
  }
}

// The sources past the first pass (source k T + t on thread t, k >= S),
// and all of them where the lists are in device scratch (`from`): each
// reads its correspondence back from the scratch.
__device__ __forceinline__ int from(const Args& a) {
  return a.lists_global ? 0 : a.first;
}

__device__ __noinline__ void rest_gather(const Args a, int bin_p,
                                         int bin_a) {
  const Layout L(a);
  const float4* rec = a.rec();
  const int t = threadIdx.x, T = blockDim.x;
  const int bin2[2] = {bin_p, bin_a};
  for (int i = from(a) + t; i - t < a.N; i += T) {
    const float4 r = rec[2 * (size_t)min(i, a.N - 1) + 1];
    gather(i < a.N && r.w > 0.f, fabsf(r.z), bin2, L.cq, L.list, a.N);
  }
}

__device__ __noinline__ void rest_rank(const Args a, int bin_p, int bin_a,
                                       int below_p, int below_a, int pp,
                                       int pa, int hsel) {
  const Layout L(a);
  const float4* rec = a.rec();
  const int bin2[2] = {bin_p, bin_a}, below2[2] = {below_p, below_a};
  for (int i = from(a) + threadIdx.x; i < a.N; i += blockDim.x) {
    const float4 r = rec[2 * (size_t)i + 1];
    rank(r.w > 0.f, fabsf(r.z), bin2, below2, L.hist + BINS * hsel, L.list,
         pp, pa, L.qslot, a.N);
  }
}

// The first GN step's group partials of the sources k T + t from
// `from`: px, py the round's position, thr the trimming threshold.
__device__ __noinline__ void rest_step1(const Args a, float px, float py,
                                        float thr) {
  const Layout L(a);
  const float4* rec = a.rec();
  const int t = threadIdx.x, T = blockDim.x, nw = T >> 5;
  float* part = L.list + 2 * a.N;
  for (int k = from(a) / T; k * T < a.N; ++k) {
    const int i = k * T + t;
    float c1[1][NV1] = {};
    if (i < a.N) {
      const float4 q = rec[2 * (size_t)i], r = rec[2 * (size_t)i + 1];
      const float e = fabsf(r.z);
      const float ws = (r.w > 0.f && e <= thr + 1e-12f) ? 1.f : 0.f;
      STEP1_TERMS(c1[0], ws, q.z, q.w, r.x, r.y, r.z, e);
    }
    group_partials<1, NV1>(c1, part + k * nw * NV1, nw);
  }
}

// The second step's, from the updated pose (c, sn, px1, py1).
__device__ __noinline__ void rest_step2(const Args a, float c, float sn,
                                        float px1, float py1, float thr) {
  const Layout L(a);
  const float4* rec = a.rec();
  const int t = threadIdx.x, T = blockDim.x, nw = T >> 5;
  const int G = (a.N + a.first - 1) / a.first * (a.first / T);  // C S
  float* part = L.list + 2 * a.N + G * nw * NV1;
  const size_t sb = (size_t)blockIdx.x * a.N;
  for (int k = from(a) / T; k * T < a.N; ++k) {
    const int i = k * T + t;
    float c2[1][NV2] = {};
    if (i < a.N) {
      const Source p = load_source(a.src, a.sv, sb, i, a.N);
      const float4 q = rec[2 * (size_t)i], r = rec[2 * (size_t)i + 1];
      const float ws = (r.w > 0.f && fabsf(r.z) <= thr + 1e-12f) ? 1.f : 0.f;
      STEP2_TERMS(c2[0], ws, q.z, q.w, q.x, q.y, p.x, p.y);
    }
    group_partials<1, NV2>(c2, part + k * nw * NV2, nw);
  }
}

// One block a pair (see above). The first pass (source s T + t on thread
// t) is the kernel as it was without chunks, on chunk 0 of the targets
// (mc of them: all where the targets take one chunk), its lists and
// partials in shared memory. Where the shape takes chunks (rest_*), its
// round state goes to the scratch once and is read back after each call,
// so that none of it lives across a call; where the lists are in device
// scratch, the rest_* functions take its sources too.
template <int S>
__global__ void __launch_bounds__(S == 2 ? PAIR_THREADS : MAX_THREADS / S,
                                  S == 2 ? 2 : 1) plicp_fused_kernel(
    const float* __restrict__ src, const uint8_t* __restrict__ src_valid,
    const float* __restrict__ tgt, const uint8_t* __restrict__ tgt_valid,
    const float* __restrict__ init, float* __restrict__ pose_out,
    float* __restrict__ stats_out, float* __restrict__ h_out, int N, int M,
    int rounds, float max_d2, float eps_xy, float eps_th, float q_perc,
    float q_adap, float adap_mult, int mc, int lists_global,
    float* __restrict__ scratch, int stride) {
  extern __shared__ float4 smem4[];
  const int T = blockDim.x, t = threadIdx.x, nw = T >> 5, lane = t & 31;
  const int nb = (mc + TILE - 1) / TILE, ng = (N + 31) / 32;
  const int G = (N + S * T - 1) / (S * T) * S * nw;  // groups of 32
  float4* tg = smem4;
  float4* box = tg + mc;
  int* hist = reinterpret_cast<int*>(box + nb);
  float* tinv = reinterpret_cast<float*>(hist + 2 * BINS);
  float* qslot = tinv + nb;
  int* cq = reinterpret_cast<int*>(qslot + 2);
  float* list = reinterpret_cast<float*>(cq + 2);  // 2 x N
  float* part1 = list + 2 * N;
  float* part2 = part1 + G * NV1;
  const Args args = {src, src_valid, tgt, tgt_valid, scratch, stride,
                     N, M, mc, lists_global, S * T};
  const bool more = N > S * T;    // sources past the first pass
  const bool chunked = more || mc < M;  // or targets past chunk 0

  const int b = blockIdx.x;
  Targets first = {tgt, tgt_valid, (size_t)b * M, tg, box, tinv, 0, 0};
  first.stage(0, mc);
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
  if (chunked) {  // each source's first seed, as the registers'
    int* pick = args.pick();
    for (int i = t; i < N; i += T) pick[i] = (int)(((long long)i * M) / N);
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
    // the first pass's state as the scratch holds it
    const auto reload = [&]() {
      const float4* rec = args.rec();
#pragma unroll
      for (int s = 0; s < S; ++s) {
        const int i = min(s * T + t, N - 1);
        const float4 q = rec[2 * (size_t)i], r = rec[2 * (size_t)i + 1];
        q1x[s] = q.x;
        q1y[s] = q.y;
        nx[s] = q.z;
        ny[s] = q.w;
        wx[s] = r.x;
        wy[s] = r.y;
        resid[s] = r.z;
        err[s] = fabsf(r.z);
        gate[s] = s * T + t < N && r.w > 0.f;
      }
    };
#pragma unroll
    for (int s = 0; s < S; ++s) {
      wx[s] = c * sx[s] - sn * sy[s] + px;
      wy[s] = sn * sx[s] + c * sy[s] + py;
      float best = dist2(wx[s], wy[s], tg[0]);
      int j1 = 0;
      // where the targets take chunks, rest_nn scans every source
      const bool need = s * T + t < N && sv[s] && mc == M;
      const int j0 = min(max(seed[s] - SEED / 2, 0), max(mc - SEED, 0));
      float bound = best;
      for (int k = 0; k < SEED && j0 + k < mc; ++k)
        bound = fminf(bound, dist2(wx[s], wy[s], tg[j0 + k]));
      for (int tile = 0; tile < nb; ++tile) {
        const float4 bx = box[tile];
        const float gx = fmaxf(fmaxf(bx.x - wx[s], wx[s] - bx.z), 0.f);
        const float gy = fmaxf(fmaxf(bx.y - wy[s], wy[s] - bx.w), 0.f);
        const float lb = fminf(gx * gx + gy * gy, tinv[tile]);
        if (!__any_sync(FULL, need && lb * (1.f - BOX_SLACK) <=
                                          fminf(bound, best) + 1e-30f))
          continue;  // no lane has a target here at or below its minimum
        const int end = min(tile * TILE + TILE, mc);
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
      gate[s] = need && best < max_d2 && t1.z > 0.f && tlen > 1e-9f &&
                t2.z > 0.f;
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
    if (chunked) {
      if (mc == M) {  // the first pass's state, to be read back
        float4* rec = args.rec();
#pragma unroll
        for (int s = 0; s < S; ++s) {
          const int i = s * T + t;
          if (i < N) {
            rec[2 * (size_t)i] = make_float4(q1x[s], q1y[s], nx[s], ny[s]);
            rec[2 * (size_t)i + 1] =
                make_float4(wx[s], wy[s], resid[s], gate[s] ? 1.f : 0.f);
          }
        }
      }
      rest_nn(args, c, sn, px, py, max_d2, rnd & 1);
      reload();
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
    if (!lists_global) {
#pragma unroll
      for (int s = 0; s < S; ++s) {
        const int bin = bin_of(err[s]);
        const bool in_p = gate[s] && bin == bin2[0];
        const bool in_a = gate[s] && bin == bin2[1];
        const int sp = warp_slot(in_p, &cq[0]), sa = warp_slot(in_a, &cq[1]);
        if (in_p) list[sp] = err[s];
        if (in_a) list[N + sa] = err[s];
      }
    }
    if (more) {
      rest_gather(args, bin2[0], bin2[1]);
      reload();
    }
    __syncthreads();  // 2: the two bins' errors gathered
    if (!lists_global) {
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
    }
    if (more) {
      rest_rank(args, bin2[0], bin2[1], below2[0], below2[1], pp, pa,
                rnd & 1);
      reload();
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
        STEP1_TERMS(c1[s], w[s], nx[s], ny[s], wx[s], wy[s], resid[s],
                    err[s]);
      }
      if (!lists_global) group_partials<S, NV1>(c1, part1, nw);
    }
    if (more) {
      rest_step1(args, px, py, thr);
      reload();
#pragma unroll
      for (int s = 0; s < S; ++s)
        w[s] = (gate[s] && err[s] <= thr + 1e-12f) ? 1.f : 0.f;
    }
    __syncthreads();  // 4: the first step's partials
    if (lists_global)
      group_totals<NV1>(v1, args.lists() + 2 * N, ng);
    else
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
      for (int s = 0; s < S; ++s)
        STEP2_TERMS(c2[s], w[s], nx[s], ny[s], q1x[s], q1y[s], sx[s], sy[s]);
      if (!lists_global) group_partials<S, NV2>(c2, part2, nw);
    }
    if (more) rest_step2(args, c, sn, px1, py1, thr);
    __syncthreads();  // 5: the second step's partials
    if (lists_global)
      group_totals<NV2>(v2, args.lists() + 2 * N + G * NV1, ng);
    else
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
           float adap_mult, int threads, int smem, int mc, int lists_global,
           void* scratch, int stride, cudaStream_t stream) {
  if (threads > max_threads(S)) return (int)cudaErrorInvalidValue;
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
      q_adap, adap_mult, mc, lists_global, (float*)scratch, stride);
  return (int)cudaGetLastError();
}

}  // namespace

// src (B, N, 2) f32, src_valid (B, N) bool, tgt (B, M, 2) f32, tgt_valid
// (B, M) bool, init (B, 3) f32; pose (B, 3), stats (B, 4) and h (B, 9)
// f32 out; all contiguous on one device. `threads` a block, `spt` sources
// a thread, `smem` bytes, `mc` targets a staged chunk, `lists_global` and
// the device scratch of `stride` floats a pair come from
// ops/cuda/plicp_fused.py::plicp_geometry. Returns a cudaError_t (0 on
// success; non-zero when the shape is not one the kernel takes: shared
// memory that does not hold the layout, targets chunked in other than
// whole tiles, or no scratch where the sources or the targets take more
// than one chunk or the lists are in device memory).
extern "C" int plicp_fused_launch(
    const void* src, const void* src_valid, const void* tgt,
    const void* tgt_valid, const void* init, void* pose, void* stats, void* h,
    int B, int N, int M, int rounds, float max_d2, float eps_xy, float eps_th,
    float q_perc, float q_adap, float adap_mult, int threads, int spt,
    int smem, int mc, int lists_global, void* scratch, int stride,
    void* stream) {
  if (B < 1 || N < 1 || M < 1 || threads < 32 || threads % 32 ||
      spt < 1 || spt > MAX_SOURCES || mc < 1 || mc > M ||
      (mc < M && mc % TILE))
    return (int)cudaErrorInvalidValue;
  const size_t nw = threads / 32, nb = (mc + TILE - 1) / TILE;
  const size_t chunks = (N + (size_t)threads * spt - 1) / (threads * spt);
  const size_t lists = 2 * (size_t)N + chunks * spt * nw * (NV1 + NV2);
  const size_t need_smem =
      16 * ((size_t)mc + nb) +
      4 * (2 * BINS + nb + (lists_global ? 0 : lists) + 4);
  if (lists_global && chunks == 1) return (int)cudaErrorInvalidValue;
  const bool records = chunks > 1 || mc < M;
  const size_t need_scratch =
      (records ? 9 * (size_t)N : 0) + (lists_global ? lists : 0);
  if ((size_t)smem < need_smem || (size_t)stride < need_scratch ||
      stride % 4 || (need_scratch > 0 && scratch == nullptr))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
#define PLICP_CASE(S)                                                        \
  case S:                                                                    \
    return launch<S>(src, src_valid, tgt, tgt_valid, init, pose, stats, h,   \
                     B, N, M, rounds, max_d2, eps_xy, eps_th, q_perc,        \
                     q_adap, adap_mult, threads, smem, mc, lists_global,     \
                     scratch, stride, st);
  switch (spt) {
    PLICP_CASE(1) PLICP_CASE(2) PLICP_CASE(3) PLICP_CASE(4)
    PLICP_CASE(5) PLICP_CASE(6) PLICP_CASE(7) PLICP_CASE(8)
  }
#undef PLICP_CASE
  return (int)cudaErrorInvalidValue;
}
