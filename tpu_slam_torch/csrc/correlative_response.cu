// The Karto correlative response numerators (GetResponse, Mapper.cpp:
// 819-856) over a whole candidate lattice, for every lane and angle of a
// chain group, in one launch.
//
// Replaces: tpu_slam/ops/pallas/correlative_response.py::
// responses_sliced_pallas (Pallas kernel _make_kernel). Plain PyTorch
// version: tpu_slam_torch/ops/correlative.py::sum_windows.
//
// What it computes: out[c, a, y * nx + x] = sum over beams n with
// valid[n] of grid[c, ys[c,a,n] + y * stride, xs[c,a,n] + x * stride],
// int32. The window starts (ys, xs) come from the caller (the rotated
// beam offsets rounded half away from zero and clamped to
// [0, dim - span]), so this kernel does no trigonometry: a one-ulp
// difference in a cosine would move a beam to another cell. Integer sums
// are exact in any order, so the atomics below keep the result
// bit-identical to the plain version.
//
// What bounds it on the H100: A * nx * ny * N int32 adds per lane, each
// of one byte of grid that was loaded from L2 or L1, against a grid read
// that is small by comparison (the 2,445^2 front-end grid is 6.0 MB in
// uint8, a 645^2 loop grid 0.4 MB; all of them stay in the 50 MB L2).
// The adds set the bound; the loop matcher (8 lanes x 21 angles x 81^2
// candidates x 359 beams, ~4e8 adds) is the large case, the front-end
// passes (21 x 16^2 and 11 x 3^2 candidates) are small and latency-bound.
//
// Design: one thread block per (candidate tile, angle, lane x beam
// chunk), one thread per candidate, an int32 accumulator per thread. The
// block stages its chunk of window origins (ys * W + xs, or -1 for an
// invalid beam) in shared memory; every thread of a warp then reads the
// same origin, so the skip of an invalid beam is warp-uniform and the 32
// lanes read 32 neighbouring (stride 1) or every-other (stride 2) bytes
// of one grid row. When the lattice is small (the front-end passes: 21
// angles x one tile is 21 blocks), the beams are split over blocks so the
// 132 SMs have work, and the partial sums meet by int32 atomicAdd in a
// zeroed output. The TPU kernel's one-hot selection matmuls, block-
// diagonal beam stacking and window DMAs exist only for the TPU and are
// not carried over.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int MAX_CHUNK = 1024;  // window origins staged per block

__global__ void correlative_response_kernel(
    const uint8_t* __restrict__ grid,  // (C, H, W)
    const int* __restrict__ ys,        // (C, A, N)
    const int* __restrict__ xs,        // (C, A, N)
    const uint8_t* __restrict__ valid, // (N,)
    int* __restrict__ out,             // (C, A, ny * nx), zeroed
    int H, int W, int A, int N, int nx, int ny, int stride, int chunk,
    int nsplit) {
  __shared__ int origin[MAX_CHUNK];
  const int a = blockIdx.y;
  const int c = blockIdx.z / nsplit;
  const int n0 = (blockIdx.z % nsplit) * chunk;
  const int n1 = min(N, n0 + chunk);
  const int ymax = H - ((ny - 1) * stride + 1);
  const int xmax = W - ((nx - 1) * stride + 1);
  const size_t row = ((size_t)c * A + a) * N;
  for (int n = n0 + threadIdx.x; n < n1; n += blockDim.x) {
    // the caller's starts are clamped already; clamping again keeps
    // every read inside the lane's grid whatever the caller passes
    const int y = min(max(ys[row + n], 0), ymax);
    const int x = min(max(xs[row + n], 0), xmax);
    origin[n - n0] = valid[n] ? y * W + x : -1;
  }
  __syncthreads();
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= nx * ny) return;
  const int iy = k / nx;
  const int ix = k - iy * nx;
  const uint8_t* g = grid + (size_t)c * H * W + (size_t)iy * stride * W +
                     (size_t)ix * stride;
  int acc = 0;
  for (int j = 0; j < n1 - n0; ++j) {
    const int o = origin[j];
    if (o >= 0) acc += __ldg(g + o);
  }
  atomicAdd(out + ((size_t)c * A + a) * nx * ny + k, acc);
}

}  // namespace

// grid (C, H, W) uint8, ys/xs (C, A, N) int32, valid (N,) bool as bytes,
// out (C, A, ny * nx) int32 zeroed by the caller; chunk = beams per block
// (1..MAX_CHUNK). Returns the cudaError_t of the launch.
extern "C" int correlative_response_launch(
    const void* grid, const void* ys, const void* xs, const void* valid,
    void* out, int C, int H, int W, int A, int N, int nx, int ny, int stride,
    int chunk, void* stream) {
  if (C < 1 || A < 1 || N < 1 || nx < 1 || ny < 1 || stride < 1 ||
      chunk < 1 || chunk > MAX_CHUNK || (nx - 1) * stride + 1 > W ||
      (ny - 1) * stride + 1 > H)
    return (int)cudaErrorInvalidValue;
  const int ncand = nx * ny;
  int threads = ((ncand + 31) / 32) * 32;
  if (threads > 256) threads = 256;
  const int nsplit = (N + chunk - 1) / chunk;
  const dim3 blocks((ncand + threads - 1) / threads, A, C * nsplit);
  correlative_response_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)grid, (const int*)ys, (const int*)xs,
      (const uint8_t*)valid, (int*)out, H, W, A, N, nx, ny, stride, chunk,
      nsplit);
  return (int)cudaGetLastError();
}
