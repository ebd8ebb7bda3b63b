// bitlife_vmem_batch: a stack of B bit-packed Life boards, each board
// resident on the card for the entire step loop, spread over the column
// strips of a thread-block cluster of its own.
//
// Replaces the TPU kernel mpi_and_open_mp_tpu/ops/bitlife.py:
// _vmem_bits_batch_kernel (behind life_run_vmem_bits_batch), in both of
// its forms: resident=True (the whole stack in one program's VMEM) and
// grid=(b,) (one board per program, the stack streamed through VMEM). On
// Hopper both forms are this one kernel: boards never interact, so each
// gets its own blocks, and the gate is per board
// (bitlife.py:fits_vmem_packed_batch). Same offset-ghost layout as
// bitlife_vmem, and the same words out, ghost and junk bits included.
//
// Bound on the H100: integer logic (17 SHF/LOP3 per word and step,
// chip_smoke.py:OPS_PER_WORD_STEP). A board that fits is a few thousand
// words, so a stack of a few boards is bound by the latency of its `steps`
// dependent steps, as bitlife_vmem is; one block a board (the loop of
// bitlife_common.cuh:resident_steps) pays that latency on one SM per
// board, ~2.9 us a step at 500^2 on an H100. What the design does about
// that:
//
// * Each board runs bitlife_vmem's cluster step
//   (bitlife_vmem_cluster.cuh): its columns cut into `strips` strips, one
//   block each, one cluster a board forming a ring over the board's torus,
//   a column's words in registers, ghosts pushed through distributed
//   shared memory every g steps. The grid is (strips, B) with a cluster of
//   (strips, 1, 1): blockIdx.x is the rank in the ring, blockIdx.y the
//   board (past the grid's y extent of 65 535 boards, blockIdx.z carries
//   the rest), so a cluster never spans two boards and a block touches
//   its own board's words only.
// * The card places a bounded number of clusters at once (a cluster's
//   blocks share a GPC; cudaOccupancyMaxActiveClusters). A stack with
//   more clusters runs them in waves: not an error. The geometry, chosen
//   by ops/bitlife.py:vmem_batch_launch_geometry, weighs wide clusters
//   (fast steps, few boards a wave) against narrow ones (slower steps,
//   more boards a wave).
// * The one-block geometry (strips = cluster = 1, g = rt = tau = 0) is
//   that loop, one block of 1024 threads a board with the board
//   double-buffered in shared memory. It remains for boards that no
//   cluster holds in registers (more than 512 word rows, or wider than 16
//   strips of 16 warps) and as a candidate for big stacks.
//
// The entry checks the stack and the geometry and returns a code of its
// own (below) where either is illegal; nothing here falls back to another
// geometry.
#include <cuda_runtime.h>

#include "bitlife_common.cuh"
#include "bitlife_vmem_cluster.cuh"

namespace {

using namespace vmem_cluster;

// The one-block geometry: board blockIdx.y (+ gridDim.y * blockIdx.z),
// double-buffered in the block's shared memory.
__global__ void __launch_bounds__(kOneBlockThreads)
bitlife_vmem_batch_kernel(const uint32_t* __restrict__ in,
                          uint32_t* __restrict__ out, int boards, int nw,
                          int nx, int ny, int steps) {
  extern __shared__ uint32_t smem[];
  const size_t board = blockIdx.y + static_cast<size_t>(gridDim.y) * blockIdx.z;
  if (board >= static_cast<size_t>(boards)) return;
  const size_t off = board * nw * nx;
  bitlife::resident_steps(in + off, out + off, smem, nw, nx, ny, steps);
}

const void* kernel_ptr(int rt, bool full) {
  return rt == 0 ? reinterpret_cast<const void*>(bitlife_vmem_batch_kernel)
                 : reinterpret_cast<const void*>(kernel_for(rt, full));
}

// Checks the stack and the geometry, configures the launch and asks the
// card how many clusters of it it can place at once; returns 0 or an error
// code.
int prepare(int b, int nw, int nx, int ny, int steps, int strips,
            int cluster, int g, int rt, int tau, cudaStream_t stream,
            Layout* lay, cudaLaunchConfig_t* cfg, cudaLaunchAttribute* attr,
            int* clusters) {
  if (b < 1 || ny < 0 || nx < 1 || nw != (ny + 33) / 32 || steps < 0)
    return kErrShape;
  int rc = layout(nw, nx, strips, cluster, g, rt, tau, lay);
  if (rc) return rc;
  const void* fn = kernel_ptr(rt, lay->full);
  rc = configure(fn, *lay, strips, cluster, b, stream, cfg, attr);
  if (rc) return rc;
  return max_active_clusters(fn, *cfg, cluster, clusters);
}

}  // namespace

// Advance the (b, nw, nx) packed stack `in` by `steps` steps into `out` on
// `stream`, each board over `strips` blocks of a cluster of `cluster` of
// its own with `g` ghost columns per side, `rt` rows per thread and `tau`
// copied lanes per warp side (rt = 0: one block a board, strips = cluster
// = 1, g = tau = 0). Returns 0, kErrShape (b < 1, nw is not n_words(ny),
// or an extent or the step count is out of range), kErrGeometry (an
// illegal geometry), kErrShared (its shared memory does not fit a block),
// kErrCluster (the card cannot place one cluster of it), or the CUDA
// error code of an attribute call, the occupancy query or the launch.
extern "C" int bitlife_vmem_batch(const void* in, void* out, int b, int nw,
                                  int nx, int ny, int steps, int strips,
                                  int cluster, int g, int rt, int tau,
                                  void* stream) {
  Layout lay;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  int clusters = 0;
  int rc = prepare(b, nw, nx, ny, steps, strips, cluster, g, rt, tau,
                   static_cast<cudaStream_t>(stream), &lay, &cfg, &attr,
                   &clusters);
  if (rc) return rc;
  if (clusters < 1) return kErrCluster;
  cudaError_t e;
  if (rt == 0) {
    e = cudaLaunchKernelEx(&cfg, bitlife_vmem_batch_kernel,
                           static_cast<const uint32_t*>(in),
                           static_cast<uint32_t*>(out), b, nw, nx, ny, steps);
  } else {
    Args a{static_cast<const uint32_t*>(in), static_cast<uint32_t*>(out),
           nw, nx, ny, steps, b, strips, g, tau, lay.P, lay.nq,
           lay.off_vert, lay.off_lo, lay.off_edge, lay.off_ghost};
    e = cudaLaunchKernelEx(&cfg, kernel_for(rt, lay.full), a);
  }
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

// What the CUDA runtime reports for the kernel and launch that
// bitlife_vmem_batch would make with these arguments: out[0] registers a
// thread, out[1] local (spilled) bytes a thread, out[2] static and out[3]
// dynamic shared bytes a block, out[4] the clusters the card can hold at
// once (cudaOccupancyMaxActiveClusters), out[5] threads a block. Returns
// what bitlife_vmem_batch would return before its occupancy check.
extern "C" int bitlife_vmem_batch_attributes(int b, int nw, int nx, int ny,
                                             int strips, int cluster, int g,
                                             int rt, int tau, int* out) {
  Layout lay;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  int clusters = 0;
  int rc = prepare(b, nw, nx, ny, 0, strips, cluster, g, rt, tau, nullptr,
                   &lay, &cfg, &attr, &clusters);
  if (rc) return rc;
  cudaFuncAttributes fa;
  cudaError_t e = cudaFuncGetAttributes(&fa, kernel_ptr(rt, lay.full));
  if (e != cudaSuccess) return static_cast<int>(e);
  out[0] = fa.numRegs;
  out[1] = static_cast<int>(fa.localSizeBytes);
  out[2] = static_cast<int>(fa.sharedSizeBytes);
  out[3] = static_cast<int>(lay.smem);
  out[4] = clusters;
  out[5] = lay.threads;
  return 0;
}

extern "C" const char* bitlife_vmem_batch_error(int code) {
  if (code == kErrShape)
    return "the packed stack is not (b >= 1, n_words(ny), nx >= 1) words, "
           "or steps < 0";
  if (code == kErrShared)
    return "the geometry's shared memory does not fit a block's 227 KB";
  if (code == kErrGeometry)
    return "illegal launch geometry: rows per thread not compiled (or 0 "
           "without strips = cluster = 1, g = tau = 0), strips outside [1, "
           "min(nx, 16)], a cluster other than the strips, ghosts outside "
           "[1, nx / strips], copied lanes tau outside [1, 15] or not "
           "dividing g, or more than 512 threads a block";
  if (code == kErrCluster)
    return "the card cannot place one cluster of this geometry "
           "(cudaOccupancyMaxActiveClusters returned 0)";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
