// bitlife_bitsliced: Life on a board-sliced stack - bit b of plane p's
// word at (y, x) is board 32p + b's cell (y, x) - in rounds of k <= 16
// steps over halo tiles in shared memory.
//
// Replaces the TPU kernel mpi_and_open_mp_tpu/ops/bitlife.py:
// _bitsliced_kernel (behind life_run_bitsliced_batch). The TPU keeps the
// whole (n_planes, ny, nx) stack in VMEM; a 500x500 plane is 1 MB, past
// the 227 KB a block may use, so here each plane is cut into tiles and a
// block steps one tile of one plane: grid = (x tiles, y tiles, planes).
//
// A block loads its tile plus a k-word halo on every side into shared
// memory, indexing the plane modulo (ny, nx): the window is a piece of the
// torus's periodic extension, so the torus wrap needs no host work and any
// extent works, tiles wider than the board (1x8, 8x1, 2x2) included. It
// steps the whole window k times - each word's eight neighbours are the
// eight words around it, no shifts - with the window's own edge wrap
// feeding junk in one word per step, and writes back the interior; the
// last row and column tiles are ragged and write only their part. The C
// entry point runs ceil(steps / k) such launches on the stream, ping-
// ponging between `out` and `scratch` so that the last round writes `out`;
// `in` is never written.
//
// Bound on the H100: integer-logic throughput. Each step needs at least 15
// LOP3 instructions per word (the carry-save rule of bitlife_common.cuh
// with the column sums shared between neighbouring columns; no shifts);
// device memory (or L2, where the stack fits its 50 MB) is read and
// written once per round of k steps. What the design does about the
// bound: up to 16 steps per launch from shared memory with a double buffer
// and one barrier per step, threads sliding a 3x3 register window down
// vertical strips (three shared-memory loads per word), and a tile size
// picked on the host (bitlife.py:plan_bitsliced) to fill the 132 SMs for
// the least stepped words. The price is the halo: a tile of tr x tc words
// steps (tr + 2k)(tc + 2k) words per step.
#include <cuda_runtime.h>

#include "bitlife_common.cuh"

namespace {

constexpr int kThreads = 1024;

__device__ __forceinline__ int wrap(int v, int n) {
  v %= n;
  return v < 0 ? v + n : v;
}

__global__ void __launch_bounds__(kThreads)
bitlife_bitsliced_kernel(const uint32_t* __restrict__ in,
                         uint32_t* __restrict__ out, int ny, int nx, int tr,
                         int tc, int k) {
  extern __shared__ uint32_t smem[];
  const int R = tr + 2 * k, C = tc + 2 * k;
  const size_t plane = static_cast<size_t>(blockIdx.z) * ny * nx;
  const int row0 = blockIdx.y * tr, col0 = blockIdx.x * tc;
  uint32_t* cur = smem;
  uint32_t* nxt = smem + R * C;
  for (int i = threadIdx.x; i < R * C; i += blockDim.x) {
    const int r = i / C, c = i - r * C;
    const int y = wrap(row0 - k + r, ny), x = wrap(col0 - k + c, nx);
    cur[i] = in[plane + static_cast<size_t>(y) * nx + x];
  }
  __syncthreads();
  for (int s = 0; s < k; ++s) {
    bitlife::window_step(cur, nxt, R, C, bitlife::SlicedRule());
    __syncthreads();
    uint32_t* t = cur;
    cur = nxt;
    nxt = t;
  }
  const int rows = min(tr, ny - row0), cols = min(tc, nx - col0);
  for (int i = threadIdx.x; i < rows * cols; i += blockDim.x) {
    const int r = i / cols, c = i - r * cols;
    out[plane + static_cast<size_t>(row0 + r) * nx + col0 + c] =
        cur[(r + k) * C + c + k];
  }
}

}  // namespace

// Advance the (npl, ny, nx) plane stack `in` by `steps` >= 1 steps into
// `out` on `stream`, in rounds of at most `kmax` steps over (tr, tc)
// tiles; `scratch` is a second buffer of the same size. Stores in
// `*launched` the number of kernel launches issued without error. Returns 0
// or the CUDA error code of the attribute call or the first failing launch.
extern "C" int bitlife_bitsliced(const void* in, void* out, void* scratch,
                                 int npl, int ny, int nx, int tr, int tc,
                                 int kmax, int steps, void* stream,
                                 int* launched) {
  *launched = 0;
  if (steps < 1 || kmax < 1) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem_max =
      2ull * (tr + 2 * kmax) * (tc + 2 * kmax) * sizeof(uint32_t);
  cudaError_t e = cudaFuncSetAttribute(
      bitlife_bitsliced_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem_max));
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid((nx + tc - 1) / tc, (ny + tr - 1) / tr, npl);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int rounds = (steps + kmax - 1) / kmax;
  uint32_t* bufs[2] = {static_cast<uint32_t*>(out),
                       static_cast<uint32_t*>(scratch)};
  const uint32_t* src = static_cast<const uint32_t*>(in);
  int rem = steps;
  for (int i = 0; i < rounds; ++i) {
    uint32_t* dst = bufs[(rounds - 1 - i) & 1];  // the last round writes out
    const int k = rem < kmax ? rem : kmax;
    const size_t smem = 2ull * (tr + 2 * k) * (tc + 2 * k) * sizeof(uint32_t);
    bitlife_bitsliced_kernel<<<grid, kThreads, smem, s>>>(src, dst, ny, nx,
                                                          tr, tc, k);
    e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
    ++*launched;
    src = dst;
    rem -= k;
  }
  return 0;
}

extern "C" const char* bitlife_bitsliced_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
