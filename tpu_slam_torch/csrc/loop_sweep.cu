// The offline driver's loop-candidate sweep in two launches.
//
// Replaces no TPU kernel: the JAX package sweeps on the host in numpy
// (tpu_slam/models/offline.py::_loop_candidates), over a dense T x T
// distance matrix, its mask, nonzero, argsort and unique. This computes the
// same candidates on the card, with no T x T array: the wrapper
// (ops/cuda/loop_sweep.py) states the semantics, and its plain version
// loop_sweep_plain gives the same pairs.
//
// What bounds it on the H100: not bytes (the poses are 8 bytes a scan) nor
// operations (~T^2 / 2 distances, ~10 flops each: 5 M at 984 scans), but
// latency: the greedy walk is sequential in the order of the keys, and the
// select phase is one block.
//
// Design.
// loop_sweep_cells_kernel: a warp per index cell (ci, cj) of the full
//   ceil(T / g)^2 grid, g the cell's side. The warp evaluates the cell's
//   <= g^2 pairs, a pair a lane at a time, and writes the cell's least key
//   or EMPTY: every cell is written, so nothing is zeroed and there is no
//   atomic. A key is (order bits of d2) << 32 | (i T + j): ascending keys
//   are ascending (d2, i, j), a total order. Cells that cannot hold a pair
//   j - i >= min_gap write EMPTY at once.
// loop_sweep_select_kernel: one block of 1,024 threads.
//   1. each tried pair that is its cell's key empties the cell (the cell
//      yields nothing);
//   2. the live keys are compacted into scratch (any order: a shared
//      counter a warp);
//   3. bitonic sort of the live keys, in shared memory up to SORT_SMEM of
//      them, else in place in scratch (padded to a power of two);
//   4. warp 0 walks the sorted keys 32 at a time: a lane's pair is
//      suppressed by a pick in the 8 cells around it (a pick overwrites
//      its cell's key with PICKED << 32 | i T + j), and within the 32 by
//      the earlier lanes' picks, which a loop over the lanes' conflict
//      masks settles in key order. The walk stops at `cap` picks.
//   out = [picks, live cells, i0, j0, i1, j1, ...]: one read on the host.
// The arithmetic is the reference's float32 expansion as a float32 matrix
// product with fused multiply-adds gives it, rounded as written with the
// _rn intrinsics so that nvcc contracts nothing else:
//   d2 = (n2_i + n2_j) - 2 fma(y_i, y_j, x_i x_j),  n2 = x x + y y.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef unsigned long long u64;
constexpr u64 EMPTY = ~0ull;
constexpr uint32_t PICKED = 0xfffffffeu;  // above every finite d2's bits
constexpr int SWEEP_THREADS = 256;
constexpr int SELECT_THREADS = 1024;
constexpr int SORT_SMEM = 4096;  // keys sorted in shared memory: 32 KB
constexpr unsigned FULL = 0xffffffffu;

// float bits that order as the floats do (for every non-NaN but -0)
__device__ __forceinline__ uint32_t order_bits(float f) {
  const uint32_t u = __float_as_uint(f);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float norm2(float x, float y) {
  return __fadd_rn(__fmul_rn(x, x), __fmul_rn(y, y));
}

__global__ void __launch_bounds__(SWEEP_THREADS)
    loop_sweep_cells_kernel(const float* __restrict__ poses, int stride,
                            int T, int g, int nc, int min_gap, float r2,
                            u64* __restrict__ cells) {
  const int lane = threadIdx.x & 31;
  const int64_t c =
      (int64_t)blockIdx.x * (SWEEP_THREADS / 32) + threadIdx.x / 32;
  if (c >= (int64_t)nc * nc) return;  // the whole warp
  const int ci = (int)(c / nc), cj = (int)(c % nc);
  const int i0 = ci * g, j0 = cj * g;
  const uint32_t rows = (uint32_t)min(g, T - i0);
  const uint32_t cols = (uint32_t)min(g, T - j0);
  u64 best = EMPTY;
  if (j0 + (int)cols - 1 - i0 >= min_gap) {
    for (uint32_t q = lane; q < rows * cols; q += 32) {
      const int i = i0 + (int)(q / cols), j = j0 + (int)(q % cols);
      if (j - i < min_gap) continue;
      const float xi = poses[(int64_t)i * stride];
      const float yi = poses[(int64_t)i * stride + 1];
      const float xj = poses[(int64_t)j * stride];
      const float yj = poses[(int64_t)j * stride + 1];
      const float dot = __fmaf_rn(yi, yj, __fmul_rn(xi, xj));
      const float d2 = __fsub_rn(__fadd_rn(norm2(xi, yi), norm2(xj, yj)),
                                 __fadd_rn(dot, dot));
      if (d2 <= r2) {
        const u64 key = ((u64)order_bits(d2) << 32) |
                        ((uint32_t)i * (uint32_t)T + (uint32_t)j);
        best = min(best, key);
      }
    }
  }
  for (int off = 16; off; off >>= 1)
    best = min(best, __shfl_xor_sync(FULL, best, off));
  if (lane == 0) cells[c] = best;
}

// ascending bitonic sort of a[0, n2), n2 a power of two, by the whole block
__device__ void bitonic_sort(u64* a, int n2) {
  for (int k = 2; k <= n2; k <<= 1)
    for (int h = k >> 1; h > 0; h >>= 1) {
      for (int i = threadIdx.x; i < n2; i += SELECT_THREADS) {
        const int l = i ^ h;
        if (l > i) {
          const u64 x = a[i], y = a[l];
          if ((x > y) == ((i & k) == 0)) {
            a[i] = y;
            a[l] = x;
          }
        }
      }
      __syncthreads();
    }
}

__global__ void __launch_bounds__(SELECT_THREADS)
    loop_sweep_select_kernel(const int* __restrict__ tried, int n_tried,
                             u64* __restrict__ cells,
                             u64* __restrict__ scratch, int* __restrict__ out,
                             int T, int g, int nc, int gap, int cap) {
  __shared__ u64 sorted_smem[SORT_SMEM];
  __shared__ int n_live, n_cleared;
  const int tid = threadIdx.x, lane = tid & 31;
  if (tid == 0) n_live = n_cleared = 0;
  __syncthreads();
  // 1. a tried pair that is its cell's nearest empties the cell
  for (int t = tid; t < n_tried; t += SELECT_THREADS) {
    const int a = tried[2 * t], b = tried[2 * t + 1];
    const int64_t c = (int64_t)(a / g) * nc + b / g;
    const u64 key = cells[c];
    if (key != EMPTY &&
        (uint32_t)key == (uint32_t)a * (uint32_t)T + (uint32_t)b) {
      cells[c] = EMPTY;
      atomicAdd(&n_cleared, 1);
    }
  }
  __syncthreads();
  // 2. the live keys into scratch
  const int64_t N = (int64_t)nc * nc;
  for (int64_t base = 0; base < N; base += SELECT_THREADS) {
    const int64_t c = base + tid;
    const u64 key = c < N ? cells[c] : EMPTY;
    const unsigned m = __ballot_sync(FULL, key != EMPTY);
    int at = 0;
    if (lane == 0 && m) at = atomicAdd(&n_live, __popc(m));
    at = __shfl_sync(FULL, at, 0);
    if (key != EMPTY) scratch[at + __popc(m & ((1u << lane) - 1u))] = key;
  }
  __syncthreads();
  // 3. sorted
  const int n = n_live;
  int n2 = 1;
  while (n2 < n) n2 <<= 1;
  u64* keys = n2 <= SORT_SMEM ? sorted_smem : scratch;
  for (int k = tid; k < n2; k += SELECT_THREADS)
    keys[k] = k < n ? scratch[k] : EMPTY;
  __syncthreads();
  bitonic_sort(keys, n2);
  // 4. the greedy walk
  if (tid >= 32) return;
  int picks = 0;
  for (int base = 0; base < n && picks < cap; base += 32) {
    const bool valid = base + lane < n;
    const uint32_t p = valid ? (uint32_t)keys[base + lane] : 0u;
    const int i = (int)(p / (uint32_t)T), j = (int)(p % (uint32_t)T);
    const int ci = i / g, cj = j / g;
    bool alive = valid;
    for (int di = -1; di <= 1 && valid; ++di)
      for (int dj = -1; dj <= 1; ++dj) {
        const int ni = ci + di, nj = cj + dj;
        if ((di == 0 && dj == 0) || ni < 0 || nj < 0 || ni >= nc || nj >= nc)
          continue;
        const u64 v = cells[(int64_t)ni * nc + nj];
        if ((uint32_t)(v >> 32) == PICKED) {
          const uint32_t q = (uint32_t)v;
          const int a = (int)(q / (uint32_t)T), b = (int)(q % (uint32_t)T);
          if (abs(i - a) < gap && abs(j - b) < gap) alive = false;
        }
      }
    // the earlier lanes of this batch whose pick would suppress this one
    unsigned conflict = 0;
    for (int m = 0; m < 32; ++m) {
      const int im = __shfl_sync(FULL, i, m), jm = __shfl_sync(FULL, j, m);
      if (m < lane && abs(i - im) < gap && abs(j - jm) < gap)
        conflict |= 1u << m;
    }
    const unsigned live = __ballot_sync(FULL, alive);
    unsigned take = 0;
    int count = picks;
    for (int m = 0; m < 32; ++m) {
      const unsigned cm = __shfl_sync(FULL, conflict, m);
      if (((live >> m) & 1u) && !(cm & take) && count < cap) {
        take |= 1u << m;
        ++count;
      }
    }
    if ((take >> lane) & 1u) {
      const int r = picks + __popc(take & ((1u << lane) - 1u));
      out[2 + 2 * r] = i;
      out[3 + 2 * r] = j;
      cells[(int64_t)ci * nc + cj] = ((u64)PICKED << 32) | p;
    }
    picks = count;
    __syncwarp();
  }
  if (lane == 0) {
    out[0] = picks;
    out[1] = n + n_cleared;
  }
}

}  // namespace

// poses: T rows of `stride` floats, x and y first; tried: n_tried (a, b)
// int32 pairs, 0 <= a, b < T; cells: ceil(T / g)^2 keys, at most 2^29 (the
// sort's int indices and sizes stay below 2^31); scratch: the next power of
// two at or above that; out: 2 + 2 cap int32.
extern "C" int loop_sweep_launch(const void* poses, int stride, int T,
                                 const void* tried, int n_tried, void* cells,
                                 void* scratch, void* out, int g, int gap,
                                 int min_gap, float r2, int cap,
                                 void* stream) {
  if (T < 1 || T > 65535 || stride < 2 || g < 1 || g > T || cap < 1 ||
      n_tried < 0 || (n_tried > 0 && tried == nullptr))
    return (int)cudaErrorInvalidValue;
  const int nc = (T + g - 1) / g;
  if ((int64_t)nc * nc > 0x20000000) return (int)cudaErrorInvalidValue;
  const int64_t blocks =
      ((int64_t)nc * nc + SWEEP_THREADS / 32 - 1) / (SWEEP_THREADS / 32);
  const cudaStream_t s = (cudaStream_t)stream;
  loop_sweep_cells_kernel<<<(unsigned)blocks, SWEEP_THREADS, 0, s>>>(
      (const float*)poses, stride, T, g, nc, min_gap, r2, (u64*)cells);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  loop_sweep_select_kernel<<<1, SELECT_THREADS, 0, s>>>(
      (const int*)tried, n_tried, (u64*)cells, (u64*)scratch, (int*)out, T,
      g, nc, gap, cap);
  return (int)cudaGetLastError();
}
