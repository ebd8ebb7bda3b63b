// bitlife_window: k fused Life steps over whole halo-extended shard
// windows of a bit-packed board, one window per thread block.
//
// Replaces the TPU kernel mpi_and_open_mp_tpu/ops/bitlife.py:
// make_window_stepper (its kernel), which runs one shard of the sharded
// bitfused path when the shard's whole window fits VMEM: the shard plus
// the ghost words (h per side in y) and ghost columns (hx per side in x)
// that the host exchanged, k <= min(32 h, hx or 128) steps, interior
// written back. Here the input is a stack of S such windows, (S, nw + 2h,
// W + 2hx) words, and the output the (S, nw, W) interiors: one launch
// advances every shard of a mesh held on this card, as one shard_map
// program advances every device's shard.
//
// One block per window. It copies the window from device memory into
// shared memory (a double buffer: the step reads one copy and writes the
// other), steps the whole window k times there with the carry-save rule of
// bitlife_common.cuh, and writes back only the interior. Both axes wrap at
// the window's edge; the junk that this feeds in walks one bit row (y) and
// one column (x) per step, so the interior is exact while k <= 32 h and
// k <= hx (with hx == 0 the window's columns are the whole torus, and k is
// held to the fused kernels' 128). The entry point checks k and the
// shared-memory fit and returns a code of its own (below) for either.
//
// Bound on the H100: integer logic, not device memory. Each launch reads
// and writes each window once for k steps of at least 17 SHF/LOP3
// instructions per word (chip_smoke.py:OPS_PER_WORD_STEP), halo words
// included. A mesh of 8 shards gives 8 blocks, so 124 of the 132 SMs stay
// idle: the kernel is bounded by the SMs it occupies, not the card's rate.
// What the design does about that: the step loop runs from shared memory
// with one barrier per step, and threads slide a 3x3 register window down
// vertical strips (three shared-memory loads per word). Splitting a
// window over several blocks (a cluster sharing its halo through
// distributed shared memory) is later work.
#include <cuda_runtime.h>

#include "bitlife_common.cuh"

namespace {

constexpr int kThreads = 1024;
constexpr int kMaxSharedBytes = 232448;
constexpr int kMaxSteps = 128;
// Codes of the entry point's own checks (CUDA's error codes are positive).
constexpr int kErrSteps = -1;
constexpr int kErrShared = -2;

__global__ void __launch_bounds__(kThreads)
bitlife_window_kernel(const uint32_t* __restrict__ ext,
                      uint32_t* __restrict__ out, int nw, int W, int h,
                      int hx, int k) {
  extern __shared__ uint32_t smem[];
  const int R = nw + 2 * h, C = W + 2 * hx;
  const uint32_t* src = ext + static_cast<size_t>(blockIdx.x) * R * C;
  uint32_t* dst = out + static_cast<size_t>(blockIdx.x) * nw * W;
  uint32_t* cur = smem;
  uint32_t* nxt = smem + R * C;
  for (int i = threadIdx.x; i < R * C; i += blockDim.x) cur[i] = src[i];
  __syncthreads();
  for (int s = 0; s < k; ++s) {
    bitlife::window_step(cur, nxt, R, C);
    __syncthreads();
    uint32_t* t = cur;
    cur = nxt;
    nxt = t;
  }
  for (int i = threadIdx.x; i < nw * W; i += blockDim.x) {
    const int r = i / W, c = i - r * W;
    dst[i] = cur[(r + h) * C + hx + c];
  }
}

}  // namespace

// k fused steps of `shards` stacked (nw + 2h, W + 2hx) windows `ext` into
// their (nw, W) interiors `out` on `stream`, one block per window. Returns
// 0, kErrSteps (k past the halo depth, or bad extents), kErrShared (the
// window does not fit a block's shared memory), or the CUDA error code of
// the attribute call or the launch.
extern "C" int bitlife_window(const void* ext, void* out, int shards, int nw,
                              int W, int h, int hx, int k, void* stream) {
  const int x_steps = hx > 0 ? hx : kMaxSteps;
  const int k_max = 32 * h < x_steps ? 32 * h : x_steps;
  if (shards < 0 || nw < 1 || W < 1 || h < 1 || hx < 0 || k < 0 ||
      k > k_max)
    return kErrSteps;
  const size_t smem =
      2ull * (nw + 2 * h) * (W + 2 * hx) * sizeof(uint32_t);
  if (smem > static_cast<size_t>(kMaxSharedBytes)) return kErrShared;
  if (shards == 0) return 0;
  cudaError_t e = cudaFuncSetAttribute(
      bitlife_window_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  bitlife_window_kernel<<<shards, kThreads, smem,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(ext), static_cast<uint32_t*>(out), nw, W,
      h, hx, k);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* bitlife_window_error(int code) {
  if (code == kErrSteps)
    return "k exceeds the window's halo depth min(32 h, hx or 128), or an "
           "extent is out of range";
  if (code == kErrShared)
    return "the double-buffered window does not fit a block's 227 KB of "
           "shared memory";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
