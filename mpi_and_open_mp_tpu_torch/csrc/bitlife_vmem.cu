// bitlife_vmem: a whole bit-packed Life board resident in one thread
// block's shared memory for the entire step loop.
//
// Replaces the TPU kernel mpi_and_open_mp_tpu/ops/bitlife.py:
// _vmem_bits_kernel (the VMEM-resident packed loop behind
// life_run_vmem_bits). Same offset-ghost layout: bit p of a packed column
// is board row p - 1; positions 0 and ny + 1 are torus ghosts, refreshed
// from live rows before every step.
//
// Bound on the H100: integer-logic throughput of ONE SM. The board never
// leaves shared memory between steps, so device memory is read and written
// once per call; each step needs at least 17 SHF/LOP3 instructions per
// word (32 cells; see bitlife_common.cuh). A single block runs on a single SM of the card's 132, so the
// kernel's ceiling is 1/132 of the card's integer rate; it is built for
// boards small enough that one step is a few microseconds (p46gun_big,
// 500x500, packs to 16 x 500 words = 32 KB) and the loop's 10 000 steps
// need no launch, no device-memory traffic and no host round trip between
// them. What the design does about the bound: a double buffer (the step
// reads one copy and writes the other, one barrier per step plus one after
// the ghost refresh), threads arranged as vertical strips that slide a
// 3x3 register window (three shared-memory loads per word), and all 1024
// threads of the block busy even on narrow boards (rows split into
// segments). Gate: 2 buffers x 4 bytes per word within the 227 KB a block
// may use (bitlife.py:fits_vmem_packed).
#include <cuda_runtime.h>

#include "bitlife_common.cuh"

namespace {

constexpr int kThreads = 1024;

__global__ void __launch_bounds__(kThreads)
bitlife_vmem_kernel(const uint32_t* __restrict__ in, uint32_t* __restrict__ out,
                    int nw, int nx, int ny, int steps) {
  extern __shared__ uint32_t smem[];
  const int n = nw * nx;
  uint32_t* cur = smem;
  uint32_t* nxt = smem + n;
  for (int i = threadIdx.x; i < n; i += blockDim.x) cur[i] = in[i];
  // Ghost positions: 0 <- ny (board row ny-1), ny+1 <- 1 (board row 0).
  const int w_lo = ny >> 5, b_lo = ny & 31;
  const int w_hi = (ny + 1) >> 5, b_hi = (ny + 1) & 31;
  __syncthreads();
  for (int s = 0; s < steps; ++s) {
    // One thread per column does both ghost bits in order (they may share
    // word 0 when nw == 1).
    for (int c = threadIdx.x; c < nx; c += blockDim.x) {
      const uint32_t w0 = (cur[c] & ~1u) | ((cur[w_lo * nx + c] >> b_lo) & 1u);
      cur[c] = w0;
      const uint32_t hi = cur[w_hi * nx + c];
      cur[w_hi * nx + c] = (hi & ~(1u << b_hi)) | (((w0 >> 1) & 1u) << b_hi);
    }
    __syncthreads();
    bitlife::window_step(cur, nxt, nw, nx);
    __syncthreads();
    uint32_t* t = cur;
    cur = nxt;
    nxt = t;
  }
  for (int i = threadIdx.x; i < n; i += blockDim.x) out[i] = cur[i];
}

}  // namespace

// Advance the (nw, nx) packed board `in` by `steps` steps into `out` on
// `stream`. Returns 0 or the CUDA error code of the attribute call or the
// launch.
extern "C" int bitlife_vmem(const void* in, void* out, int nw, int nx, int ny,
                            int steps, void* stream) {
  const size_t smem = 2ull * nw * nx * sizeof(uint32_t);
  cudaError_t e = cudaFuncSetAttribute(
      bitlife_vmem_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  bitlife_vmem_kernel<<<1, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(in), static_cast<uint32_t*>(out), nw, nx,
      ny, steps);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* bitlife_vmem_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
