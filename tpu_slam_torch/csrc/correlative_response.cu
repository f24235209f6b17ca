// The Karto correlative response numerators (GetResponse, Mapper.cpp:
// 819-856) over a whole candidate lattice, for every lane and angle of a
// group, in one launch.
//
// Replaces: tpu_slam/ops/pallas/correlative_response.py::
// responses_sliced_pallas (Pallas kernel _make_kernel). Plain PyTorch
// version: tpu_slam_torch/ops/correlative.py::sum_windows.
//
// What it computes: out[c, a, y * nx + x] = sum over beams n with
// valid[c * vstride + n] of grid[c, ys[c,a,n] + y * stride, xs[c,a,n] +
// x * stride], int32: the lanes share one scan's beam flags (vstride 0,
// a chain group) or each has its own (vstride N, an anchor group). The
// window starts (ys, xs) come from the caller (the rotated beam offsets
// rounded half away from zero and clamped to [0, dim - span]), so this
// kernel does no trigonometry: a one-ulp difference in a cosine would
// move a beam to another cell. The grid holds Karto's values 0..100.
//
// What bounds it on the H100: one add per lane, heading, candidate and
// valid beam, each of one byte of grid read through L1 (the loop matcher:
// 8 lanes x 21 angles x 81^2 candidates x 359 beams, ~4e8; the outdoor
// long anchors: 8 lanes of 5,093^2 grids, 207 MB, whose windows read
// 19 MB). A thread a candidate spends a load, a flag test and an add on
// each candidate and beam: there the issue slots, not the memory, set the
// pace. The small passes (the front and fine passes, a few thousand
// candidates) are a chain of latencies: loads, barriers.
//
// Design:
// - Large lattices (the row path, strides 1 and 2, grid rows a multiple
//   of 8 bytes apart at the stride): a thread owns one aligned 8-byte
//   chunk of a lattice row's window and loads it once a beam (a warp's
//   loads cover 1 to 3 rows' bytes). A beam's window starts at byte O =
//   0..7 of its first chunk, the same in every row, so which candidate a
//   byte belongs to shifts with O: the block stages its valid beams
//   bucketed by O, and a thread keeps 8 sets of sums, one a class, each
//   loop over a class's beams with its byte selection fixed. Pairs of
//   bytes go by one PRMT into the 16-bit halves of a register (the upper
//   byte of each half the sign of the byte taken: 0 for 0..127), one
//   32-bit add for two candidates. A chunk is loaded only for classes
//   whose window it holds bytes of, so no load leaves the grid. At the end
//   each candidate sums its 8 classes' bytes from shared memory (laid out
//   class by thread: no bank conflict).
// - Small lattices (the byte path: the front passes, the anchors' short
//   and fine passes; also other strides and grids): a thread owns R = 2
//   neighbouring candidates of a row and loads a byte a candidate, the
//   two added in the halves of one register, and reads only
//   candidates inside the lattice. The lattice is cut into tiles of G
//   strips and a block's beams split over K slices of its threads, whose
//   partials meet in shared memory (each output summed by a group of lanes
//   with xor shuffles): the split is chosen to fill the card with short
//   chains of loads, since these passes are a chain of latencies.
// - Sums in 16-bit halves are flushed into int32 after each round of at
//   most 512 staged beams (512 x 100 <= 65,535), so any N stays exact.
// - Invalid beams are compacted away when the origins are staged: the
//   inner loops have no flag test. Integer sums do not depend on order.
// - A block is (candidate tile, heading, lane), ordered lane-major
//   so that one lane's windows stay in L2 while its blocks run. Every
//   output element is written once, by one block: one launch, no zeroing,
//   no atomics.

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int STAGE = 512;  // valid beams staged a round
// a thread sums at most a round's beams in 16-bit halves before it flushes
// them into int32: 512 x 100 <= 65,535
static_assert(STAGE * 100 <= 0xffff, "a 16-bit half would overflow");
constexpr int MIN_THREADS = 64;
constexpr int MAX_THREADS = 1024;
constexpr int CLASSES = 8;  // a window's start in its first 8-byte chunk
constexpr int CHUNKS = STAGE / 32;  // a round's beams, 32 to a ballot
constexpr int OWN = CHUNKS / (MIN_THREADS / 32);  // chunks a warp stages
constexpr int PER = STAGE / MIN_THREADS;  // beams a thread stages a round

__device__ __forceinline__ unsigned prmt(unsigned lo, unsigned hi,
                                         unsigned sel) {
  unsigned d;
  asm("prmt.b32 %0, %1, %2, %3;" : "=r"(d) : "r"(lo), "r"(hi), "r"(sel));
  return d;
}

// The PRMT selector that puts bytes b0 and b1 of {hi:lo} into the low
// bytes of two 16-bit halves, each upper byte the sign of the byte taken.
__host__ __device__ constexpr unsigned pair_sel(unsigned b0, unsigned b1) {
  return b0 | (8u | b0) << 4 | b1 << 8 | (8u | b1) << 12;
}

// What a block needs of the launch.
struct Pass {
  const uint8_t* grid;   // (C, H, W)
  const int* ys;         // (C, A, N)
  const int* xs;         // (C, A, N)
  const uint8_t* valid;  // (C, N), lane stride vstride
  int* out;              // (C, A, ny * nx)
  int H, W, A, N, nx, ny, stride, vstride, strips_row, G, K, tiles;
};

// A beam's window origin, its start clamped to [0, dim - span].
__device__ __forceinline__ int origin(const Pass& p, size_t row, int n) {
  return min(max(p.ys[row + n], 0), p.H - ((p.ny - 1) * p.stride + 1)) * p.W +
         min(max(p.xs[row + n], 0), p.W - ((p.nx - 1) * p.stride + 1));
}

// Row path: a thread's sums of the beams of class O (each window starts
// at byte O of its first 8-byte chunk), slots [start[O], start[O + 1]) of
// the staged aligned offsets. p: the thread's chunk less the offset. The
// chunk holds bytes of the window only where 8 j <= O + S (nx - 1); the
// others load nothing. At stride 2 the chunk's candidates are its bytes
// of O's parity, (p, p + 2) and (p + 4, p + 6); at stride 1 all 8, in
// pairs.
template <int S, int O>
__device__ __forceinline__ void add_class(const int* staged,
                                          const int (&start)[CLASSES + 1],
                                          const uint8_t* p, int j, int nx,
                                          unsigned (&pk)[CLASSES][4 / S]) {
  if (8 * j > O + S * (nx - 1)) return;
  constexpr unsigned par = O & 1;
#pragma unroll 4
  for (int jb = start[O]; jb < start[O + 1]; ++jb) {
    const uint2 w = __ldg(reinterpret_cast<const uint2*>(p + staged[jb]));
    if constexpr (S == 2) {
      pk[O][0] += prmt(w.x, w.y, pair_sel(par, par + 2));
      pk[O][1] += prmt(w.x, w.y, pair_sel(par + 4, par + 6));
    } else {
#pragma unroll
      for (int q = 0; q < 4; ++q)
        pk[O][q] += prmt(w.x, w.y, pair_sel(2 * q, 2 * q + 1));
    }
  }
}

// The row path (stride S): G = whole lattice rows of strips_row chunks a
// block, one slice.
template <int S>
__device__ void rows_pass(const Pass& p, int* smem) {
  constexpr int SLOTS = 8 / S;  // a chunk's candidates of a class
  constexpr int E = CLASSES * CHUNKS / 32;  // cnt entries a lane scans
  __shared__ int cnt[CLASSES * CHUNKS];  // a round's valid beams by class
  int* sums = smem + STAGE;  // [class][slot][thread]: no bank conflict
  const int t = threadIdx.x, lane = t & 31, wid = t >> 5;
  const int cpw = (CHUNKS + (blockDim.x >> 5) - 1) / (blockDim.x >> 5);
  const int tile = blockIdx.x % p.tiles, ca = blockIdx.x / p.tiles;
  const int c = ca / p.A, a = ca - c * p.A;
  const int rows = p.G / p.strips_row, y0 = tile * rows;
  const bool work = t < p.G && y0 + t / p.strips_row < p.ny;
  const int y = work ? y0 + t / p.strips_row : 0;
  const int j = t % p.strips_row;  // the thread's chunk of its row
  const uintptr_t base =
      reinterpret_cast<uintptr_t>(p.grid + (size_t)c * p.H * p.W);
  const uint8_t* gb = reinterpret_cast<const uint8_t*>(base & ~(uintptr_t)7);
  const size_t row = ((size_t)c * p.A + a) * p.N;
  const uint8_t* v = p.valid + (size_t)c * p.vstride;
#pragma unroll
  for (int i = 0; i < CLASSES * SLOTS; ++i) sums[i * blockDim.x + t] = 0;

  for (int n0 = 0; n0 < p.N; n0 += STAGE) {
    const int n1 = min(p.N, n0 + STAGE);
    // stage the round's valid beams bucketed by class: warp w loads chunks
    // w * cpw ... of 32 beams (all its loads issued together) and counts
    // each chunk's beams of each class by ballots into cnt[class][chunk];
    // after a barrier every warp scans cnt, and each chunk's owner writes
    // its beams' aligned offsets at their slots
    int org[OWN], rank[OWN], cls[OWN];
    bool f[OWN];
#pragma unroll
    for (int q = 0; q < OWN; ++q) {
      const int n = n0 + 32 * (wid * cpw + q) + lane;
      f[q] = false;
      org[q] = 0;
      if (q < cpw && n < n1) {
        f[q] = v[n] != 0;
        org[q] = origin(p, row, n) + (int)(base & 7);
      }
    }
#pragma unroll
    for (int q = 0; q < OWN; ++q) {
      const int i = wid * cpw + q;
      cls[q] = org[q] & 7;
      rank[q] = 0;
      if (q < cpw && i < CHUNKS) {  // uniform in the warp
#pragma unroll
        for (int b = 0; b < CLASSES; ++b) {
          const unsigned m = __ballot_sync(0xffffffffu, f[q] && cls[q] == b);
          if (lane == b) cnt[b * CHUNKS + i] = __popc(m);
          if (cls[q] == b) rank[q] = __popc(m & ((1u << lane) - 1));
        }
      }
    }
    __syncthreads();
    int sum = 0;  // entries lane * E ... of cnt, class-major
#pragma unroll
    for (int q = 0; q < E; ++q) sum += cnt[lane * E + q];
    int scan = sum;  // inclusive scan over the warp's lanes
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int up = __shfl_up_sync(0xffffffffu, scan, d);
      if (lane >= d) scan += up;
    }
    const int pre = scan - sum;  // the slots before this lane's entries
    int start[CLASSES + 1];  // each class's first slot; then the count
#pragma unroll
    for (int b = 0; b < CLASSES; ++b)
      start[b] = __shfl_sync(0xffffffffu, pre, b * CHUNKS / E);
    start[CLASSES] = __shfl_sync(0xffffffffu, scan, 31);
#pragma unroll
    for (int q = 0; q < OWN; ++q) {
      const int i = wid * cpw + q;
      if (q < cpw && i < CHUNKS) {  // uniform in the warp
        const int e = cls[q] * CHUNKS + i;
        int slot = __shfl_sync(0xffffffffu, pre, e / E) + rank[q];
        for (int e2 = e / E * E; e2 < e; ++e2) slot += cnt[e2];
        if (f[q]) smem[slot] = org[q] & ~7;
      }
    }
    __syncthreads();
    if (work) {
      unsigned pk[CLASSES][SLOTS / 2];
#pragma unroll
      for (int b = 0; b < CLASSES; ++b)
#pragma unroll
        for (int q = 0; q < SLOTS / 2; ++q) pk[b][q] = 0;
      const uint8_t* pc = gb + (y * p.stride * p.W + 8 * j);
      add_class<S, 0>(smem, start, pc, j, p.nx, pk);
      add_class<S, 1>(smem, start, pc, j, p.nx, pk);
      add_class<S, 2>(smem, start, pc, j, p.nx, pk);
      add_class<S, 3>(smem, start, pc, j, p.nx, pk);
      add_class<S, 4>(smem, start, pc, j, p.nx, pk);
      add_class<S, 5>(smem, start, pc, j, p.nx, pk);
      add_class<S, 6>(smem, start, pc, j, p.nx, pk);
      add_class<S, 7>(smem, start, pc, j, p.nx, pk);
#pragma unroll
      for (int b = 0; b < CLASSES; ++b)
#pragma unroll
        for (int q = 0; q < SLOTS / 2; ++q) {
          sums[(b * SLOTS + 2 * q) * blockDim.x + t] +=
              (int)(pk[b][q] & 0xffffu);
          sums[(b * SLOTS + 2 * q + 1) * blockDim.x + t] +=
              (int)(pk[b][q] >> 16);
        }
    }
    __syncthreads();  // the offsets and cnt are written again; sums read
  }
  // candidate i of a row is byte O + S * i of the row's chunks, for the
  // class O of each beam: the sum over the classes
  int* o = p.out + ((size_t)c * p.A + a) * p.nx * p.ny;
  for (int e = t; e < rows * p.nx; e += blockDim.x) {
    const int yl = e / p.nx, i = e - yl * p.nx;
    if (y0 + yl >= p.ny) break;
    int total = 0;
#pragma unroll
    for (int b = 0; b < CLASSES; ++b) {
      const int byte = b + S * i;
      total += sums[(b * SLOTS + ((byte & 7) >> (S - 1))) * blockDim.x +
                    yl * p.strips_row + (byte >> 3)];
    }
    o[(y0 + yl) * p.nx + i] = total;
  }
}

// The byte path (R candidates a thread, any stride): G strips of a tile a
// block, K beam slices.
template <int R>
__device__ void bytes_pass(const Pass& p, int* smem) {
  __shared__ int warp_valid[MAX_THREADS / 32];
  const int t = threadIdx.x, lane = t & 31, wid = t >> 5;
  const int nwarps = blockDim.x >> 5;
  const int tile = blockIdx.x % p.tiles, ca = blockIdx.x / p.tiles;
  const int c = ca / p.A, a = ca - c * p.A;
  const int s = t % p.G, k = t / p.G;
  const int strip = tile * p.G + s;
  const bool work = k < p.K && strip < p.ny * p.strips_row;
  const int y = work ? strip / p.strips_row : 0;
  const int j = work ? strip - y * p.strips_row : 0;  // strip in its row
  const uint8_t* gs = p.grid + (size_t)c * p.H * p.W +
                      (y * p.stride * p.W + j * R * p.stride);
  const int left = p.nx - j * R;  // the strip's candidates in the row
  const size_t row = ((size_t)c * p.A + a) * p.N;
  const uint8_t* v = p.valid + (size_t)c * p.vstride;
  int acc[R];
#pragma unroll
  for (int i = 0; i < R; ++i) acc[i] = 0;
  for (int n0 = 0; n0 < p.N; n0 += STAGE) {
    const int n1 = min(p.N, n0 + STAGE);
    // stage the round's valid beams: thread t takes n0 + t + i * threads
    // (all loads issued together); a block-wide exclusive scan of the
    // counts gives each its slots
    int org[PER];
    unsigned ok = 0;
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      const int n = n0 + t + i * (int)blockDim.x;
      org[i] = 0;
      if (n < n1) {
        org[i] = origin(p, row, n);
        ok |= (unsigned)(v[n] != 0) << i;
      }
    }
    const int mine = __popc(ok);
    int scan = mine;  // inclusive scan within the warp
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int up = __shfl_up_sync(0xffffffffu, scan, d);
      if (lane >= d) scan += up;
    }
    if (lane == 31) warp_valid[wid] = scan;
    __syncthreads();
    int slot = scan - mine, count = 0;
    for (int w = 0; w < nwarps; ++w) {
      const int q = warp_valid[w];
      count += q;
      if (w < wid) slot += q;
    }
#pragma unroll
    for (int i = 0; i < PER; ++i)
      if (ok >> i & 1) smem[slot++] = org[i];
    __syncthreads();
    if (work) {
      const int lo = (int)((long long)k * count / p.K);
      const int hi = (int)((long long)(k + 1) * count / p.K);
      unsigned pk[R / 2];
#pragma unroll
      for (int q = 0; q < R / 2; ++q) pk[q] = 0;
#pragma unroll 4
      for (int jb = lo; jb < hi; ++jb) {
        const uint8_t* b = gs + smem[jb];
#pragma unroll
        for (int q = 0; q < R / 2; ++q) {
          const unsigned b0 = 2 * q < left ? __ldg(b + 2 * q * p.stride) : 0u;
          const unsigned b1 =
              2 * q + 1 < left ? __ldg(b + (2 * q + 1) * p.stride) : 0u;
          pk[q] += b0 | b1 << 16;
        }
      }
#pragma unroll
      for (int q = 0; q < R / 2; ++q) {
        acc[2 * q] += (int)(pk[q] & 0xffffu);
        acc[2 * q + 1] += (int)(pk[q] >> 16);
      }
    }
    if (n1 < p.N) __syncthreads();  // the origins are written again
  }
  int* o = p.out + ((size_t)c * p.A + a) * p.nx * p.ny;
  if (p.K == 1) {
    if (work) {
#pragma unroll
      for (int i = 0; i < R; ++i)
        if (i < left) o[y * p.nx + j * R + i] = acc[i];
    }
    return;
  }
  // K slices: the partials [K][ld] in shared memory past the origins,
  // then each output summed by a group of L lanes (slice q by lane q mod
  // L, xor shuffles)
  int* parts = smem + STAGE;
  const int outs = p.G * R, ld = outs | 1;  // odd: no bank conflict
  if (work) {
#pragma unroll
    for (int i = 0; i < R; ++i) parts[k * ld + s * R + i] = acc[i];
  }
  __syncthreads();
  int L = 1;
  while (2 * L <= min(p.K, 32)) L *= 2;
  const int groups = blockDim.x / L;
  for (int e0 = 0; e0 < outs; e0 += groups) {
    const int e = e0 + t / L, l = t % L;
    int sum = 0;
    if (e < outs)
      for (int q = l; q < p.K; q += L) sum += parts[q * ld + e];
    for (int d = L / 2; d > 0; d >>= 1)
      sum += __shfl_xor_sync(0xffffffffu, sum, d);
    const int st = tile * p.G + e / R;
    const int sy = st / p.strips_row;
    const int x = (st - sy * p.strips_row) * R + e % R;
    if (l == 0 && e < outs && sy < p.ny && x < p.nx) o[sy * p.nx + x] = sum;
  }
}

template <int R, int S>
__global__ void __launch_bounds__(MAX_THREADS)
    correlative_response_kernel(Pass p) {
  extern __shared__ int smem[];
  if constexpr (S)
    rows_pass<S>(p, smem);
  else
    bytes_pass<R>(p, smem);
}

template <int R, int S>
int launch(const Pass& p, int blocks, int threads, int smem,
           cudaStream_t stream) {
  if (smem > 48 * 1024) {  // the row path's class sums of a large block
    const cudaError_t e = cudaFuncSetAttribute(
        correlative_response_kernel<R, S>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
  }
  correlative_response_kernel<R, S><<<blocks, threads, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace

// grid (C, H, W) uint8 of values 0..100, ys/xs (C, A, N) int32, valid
// (C, N) bool as bytes, lane c's at valid + c * vstride (0: one scan's,
// shared), out (C, A, ny * nx) int32, every element written. Geometry: R
// candidates a thread (2: the byte path, any stride; 0: the row
// path, stride 1 or 2 with stride * W a multiple of 8, an 8-byte chunk a
// thread, G whole rows of chunks, K = 1), `threads` a block (a multiple
// of 32, 64 to 1,024), G strips a block's tile, K beam slices (G * K <=
// threads). Returns the cudaError_t of the launch.
extern "C" int correlative_response_launch(
    const void* grid, const void* ys, const void* xs, const void* valid,
    void* out, int C, int H, int W, int A, int N, int nx, int ny, int stride,
    int vstride, int R, int threads, int G, int K, void* stream) {
  if (C < 1 || A < 1 || N < 1 || nx < 1 || ny < 1 || stride < 1 ||
      vstride < 0 || (long long)(nx - 1) * stride + 1 > W ||
      (long long)(ny - 1) * stride + 1 > H ||
      (long long)H * W > INT_MAX - 64 || threads < MIN_THREADS ||
      threads > MAX_THREADS || threads % 32 != 0 || G < 1 || K < 1 ||
      (long long)G * K > threads)
    return (int)cudaErrorInvalidValue;
  const bool rows = R == 0;
  if (rows && (K != 1 || (stride != 1 && stride != 2) || stride * W % 8))
    return (int)cudaErrorInvalidValue;
  if (!rows && R != 2) return (int)cudaErrorInvalidValue;
  const int strips_row =
      rows ? (7 + (nx - 1) * stride) / 8 + 1 : (nx + R - 1) / R;
  if (rows && G % strips_row != 0) return (int)cudaErrorInvalidValue;
  const long long tiles = ((long long)ny * strips_row + G - 1) / G;
  const long long blocks = (long long)C * A * tiles;
  if (blocks > INT_MAX) return (int)cudaErrorInvalidValue;
  // the staged origins, then the row path's class sums or the byte path's
  // slice partials
  const long long words =
      STAGE + (rows ? (long long)threads * CLASSES * (8 / stride)
              : K > 1 ? (long long)K * ((G * R) | 1) : 0);
  const int smem = (int)(words * sizeof(int));
  const Pass p{(const uint8_t*)grid, (const int*)ys, (const int*)xs,
               (const uint8_t*)valid, (int*)out, H, W, A, N, nx, ny, stride,
               vstride, strips_row, G, K, (int)tiles};
  const cudaStream_t s = (cudaStream_t)stream;
  if (R == 2) return launch<2, 0>(p, (int)blocks, threads, smem, s);
  if (stride == 2) return launch<0, 2>(p, (int)blocks, threads, smem, s);
  return launch<0, 1>(p, (int)blocks, threads, smem, s);
}
