// bitlife_vmem_batch: a stack of B bit-packed Life boards, one thread
// block per board, each board resident in its block's shared memory for
// the entire step loop.
//
// Replaces the TPU kernel mpi_and_open_mp_tpu/ops/bitlife.py:
// _vmem_bits_batch_kernel (behind life_run_vmem_bits_batch), in both of
// its forms: resident=True (the whole stack in one program's VMEM) and
// grid=(b,) (one board per program, the stack streamed through VMEM). On
// Hopper a block is the unit of residency, so both forms are this one
// kernel: grid = B, blockIdx.x picks the board, and the gate is per board
// (bitlife.py:fits_vmem_packed_batch). Same offset-ghost layout as
// bitlife_vmem; boards never interact.
//
// Bound on the H100: integer-logic throughput. Device memory is read and
// written once per call; each step needs at least 17 SHF/LOP3
// instructions per word (bitlife_common.cuh). Each board runs on one SM,
// so B boards fill min(B, 132) SMs (a 500x500 board is 2 x 8000 words x
// 4 B = 64 KB of shared memory; the 1024-thread blocks allow two per SM,
// so 64 boards occupy 64 SMs). What the design does about the bound: the
// resident loop of bitlife_vmem (bitlife_common.cuh:resident_steps) per
// block - double buffer, two barriers per step, vertical strips with a
// 3x3 register window, all threads busy on narrow boards - and one launch
// for the whole stack and all steps.
#include <cuda_runtime.h>

#include "bitlife_common.cuh"

namespace {

constexpr int kThreads = 1024;

__global__ void __launch_bounds__(kThreads)
bitlife_vmem_batch_kernel(const uint32_t* __restrict__ in,
                          uint32_t* __restrict__ out, int nw, int nx, int ny,
                          int steps) {
  extern __shared__ uint32_t smem[];
  const size_t off = static_cast<size_t>(blockIdx.x) * nw * nx;
  bitlife::resident_steps(in + off, out + off, smem, nw, nx, ny, steps);
}

}  // namespace

// Advance the (b, nw, nx) packed stack `in` by `steps` steps into `out` on
// `stream`, one block per board. Returns 0 or the CUDA error code of the
// attribute call or the launch.
extern "C" int bitlife_vmem_batch(const void* in, void* out, int b, int nw,
                                  int nx, int ny, int steps, void* stream) {
  const size_t smem = 2ull * nw * nx * sizeof(uint32_t);
  cudaError_t e = cudaFuncSetAttribute(
      bitlife_vmem_batch_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  bitlife_vmem_batch_kernel<<<b, kThreads, smem,
                              static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(in), static_cast<uint32_t*>(out), nw, nx,
      ny, steps);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* bitlife_vmem_batch_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
