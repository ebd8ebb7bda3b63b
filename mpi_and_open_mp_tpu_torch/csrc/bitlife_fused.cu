// bitlife_fused: k <= 128 fused Life steps per launch over halo tiles of a
// bit-packed board.
//
// Replaces the TPU kernel mpi_and_open_mp_tpu/ops/bitlife.py:
// _fused_tiles_kernel (built by make_fused_stepper), which serves the
// aligned big-board runner life_run_fused_bits and the padded-frame runner
// life_run_frame_bits. The input is the board extended on the host with h
// torus-wrap word rows per side (h = 4 words = 128 bit rows) and, for 2-D
// tile plans, hx wrap columns per side; the output is the (nw, nx) board
// after k steps. Input and output are different buffers: blocks run in
// parallel and in no order.
//
// One block = one output tile (tr word rows x cx columns; the last row and
// column tiles may be shorter). It copies its window - the tile plus its
// halo - from device memory into shared memory, steps the whole window k
// times there, and writes back only the interior. The junk that the
// window's own wrap feeds in at its edges walks one bit row (and one
// column) per step, so the interior is exact while k <= 32 h and k <= hx.
//
// Bound on the H100: integer-logic throughput, not device memory. Each
// launch reads and writes the board once for up to 128 steps of at least
// 17 SHF/LOP3 instructions per word (see bitlife_common.cuh), so a 16384^2
// board (32 MB packed) needs ~20 us of memory traffic and ~1.1 ms of logic
// per launch of 128 steps. What the design
// does about that: the step loop runs from shared memory with a double
// buffer and one barrier per step, threads slide a 3x3 register window
// down vertical strips (three shared-memory loads per word), and the host
// (bitlife.py:plan_sharded_bits) picks the tile split that minimises the
// estimated time - waves of blocks over the 132 SMs times the window words
// each block steps, halo work included - within the 227 KB a block may use.
#include <cuda_runtime.h>

#include "bitlife_common.cuh"

namespace {

constexpr int kThreads = 1024;

__global__ void __launch_bounds__(kThreads)
bitlife_fused_kernel(const uint32_t* __restrict__ ext, uint32_t* __restrict__ out,
                     int nw, int nx, int h, int hx, int tr, int cx, int k) {
  extern __shared__ uint32_t smem[];
  const int row0 = blockIdx.y * tr, col0 = blockIdx.x * cx;
  const int rows = min(tr, nw - row0), cols = min(cx, nx - col0);
  const int R = rows + 2 * h, C = cols + 2 * hx;
  const size_t ext_w = static_cast<size_t>(nx) + 2 * hx;
  uint32_t* cur = smem;
  uint32_t* nxt = smem + R * C;
  for (int i = threadIdx.x; i < R * C; i += blockDim.x) {
    const int r = i / C, c = i - r * C;
    cur[i] = ext[(row0 + r) * ext_w + col0 + c];
  }
  __syncthreads();
  for (int s = 0; s < k; ++s) {
    bitlife::window_step(cur, nxt, R, C);
    __syncthreads();
    uint32_t* t = cur;
    cur = nxt;
    nxt = t;
  }
  for (int i = threadIdx.x; i < rows * cols; i += blockDim.x) {
    const int r = i / cols, c = i - r * cols;
    out[static_cast<size_t>(row0 + r) * nx + col0 + c] =
        cur[(r + h) * C + hx + c];
  }
}

}  // namespace

// k fused steps of the (nw + 2h, nx + 2hx) extended board `ext` into the
// (nw, nx) board `out` on `stream`, one block per (tr, cx) tile. Returns 0
// or the CUDA error code of the attribute call or the launch.
extern "C" int bitlife_fused(const void* ext, void* out, int nw, int nx, int h,
                             int hx, int tr, int cx, int k, void* stream) {
  const size_t smem =
      2ull * (tr + 2 * h) * (cx + 2 * hx) * sizeof(uint32_t);
  cudaError_t e = cudaFuncSetAttribute(
      bitlife_fused_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid((nx + cx - 1) / cx, (nw + tr - 1) / tr);
  bitlife_fused_kernel<<<grid, kThreads, smem,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(ext), static_cast<uint32_t*>(out), nw, nx,
      h, hx, tr, cx, k);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* bitlife_fused_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
