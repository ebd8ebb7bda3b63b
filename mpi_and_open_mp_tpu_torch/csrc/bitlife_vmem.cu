// bitlife_vmem: a whole bit-packed Life board resident on the card for the
// entire step loop, spread over the column strips of one thread-block
// cluster.
//
// Replaces the TPU kernel mpi_and_open_mp_tpu/ops/bitlife.py:
// _vmem_bits_kernel (the VMEM-resident packed loop behind
// life_run_vmem_bits). Same offset-ghost layout: bit p of a packed column
// is board row p - 1; positions 0 and ny + 1 are torus ghosts, refreshed
// from live rows before every step (position 0 <- position ny, then
// position ny + 1 <- position 1). Every bit of every word is stepped, the
// ghosts and the junk positions past ny + 1 included, so the output is
// word for word what the plain version (ops/bitlife.py:_vmem_steps_plain)
// gives.
//
// Bound on the H100: integer logic (17 SHF/LOP3 per word and step,
// chip_smoke.py:OPS_PER_WORD_STEP), but a board that fits here is a few
// thousand words (p46gun_big, 500x500, packs to 16 x 500 = 8000), so a
// call is bound by the latency of its `steps` dependent steps, not by any
// rate, and a single block would put the whole board on one SM of the
// card's 132. What the design does about that, as bitlife_window.cu does
// for shard windows:
//
// * The board is cut into `strips` column strips, one block (CTA) each, and
//   the strips are one cluster (at most 16 blocks, above 8 with
//   cudaFuncAttributeNonPortableClusterSizeAllowed) that forms a ring over
//   the torus: the last strip's right neighbour is the first. A block
//   holds its strip plus g ghost columns per side (L = w + 2g local
//   columns), read once from device memory (mod nx: the x wrap is exact).
//   Junk enters at a block's local edges, one column per step, so every g
//   steps each block pushes its first and last g columns into its
//   neighbours' ghost buffers (st.shared::cluster through
//   map_shared_rank), then one cluster barrier
//   (barrier.cluster.arrive.release ... wait.acquire). A strip of one is a
//   ring with itself (shuffles do not wrap): it pushes into its own ghost
//   buffers behind a block barrier, which costs less than a cluster
//   barrier. With steps <= g no refresh is needed.
// * The step runs from registers. A thread owns one column of its strip,
//   or a segment of RT rows of it (P = ceil(nw / RT) segments). Its y
//   shifts are funnel shifts of its own words (plus one word from the
//   segment above and below); each column computes its 3-cell sums once
//   and hands them to both side columns by __shfl_up/down_sync, so a word
//   costs 2 SHF + 4 LOP + the 11-operation carry-save rule
//   (bitlife_common.cuh:count_rule) + 4 SHFL, not life_word's ~49
//   operations and three shared-memory loads.
// * A warp of a multi-warp row owns 32 - 2 tau columns: its tau lanes on
//   each side copy the neighbouring warps' edge columns from shared memory
//   every tau steps, so the warps of a segment row need a block barrier
//   only every tau steps. Segments trade their top and bottom words through
//   shared memory every step (no barrier at all with one segment).
// * The y ghosts, every step, in every local column (ghosts and copies
//   included), before the step: word 0's bit 0 takes position ny (word
//   ny >> 5, bit ny & 31) and word nw - 1's bit (ny + 1) & 31 takes word
//   0's bit 1 (which the first refresh never changes). Each thread applies
//   them to its own words and to the words above and below it that the
//   segments traded, which are published unrefreshed. Position ny lies in
//   word nw - 1 or nw - 2, so in the last segment (every segment holds at
//   least 2 words when P > 1): the first segment reads it from its
//   `above` word (nw - 1) or from a word the last segment publishes each
//   step beside its top and bottom words (nw - 2); the last segment reads
//   word 0's bit 1 from the first segment's traded top word. So the bits
//   cross segments inside the step's own barrier, and segment 0 reads word
//   nw - 1 (its `above`) with the refreshed ghost bit even when that bit is
//   bit 31 (ny % 32 == 30). With nw == 1 both refreshes hit word 0, in
//   order.
// * Where every segment holds RT words (nw == P * RT, p46gun_big's 16
//   words at 4 a thread), a second form of the kernel indexes a segment's
//   last word at compile time instead of by a chain of selects.
// * The step loop counts steps since each refresh instead of dividing by
//   tau or g.
//
// Barrier order and double buffers are bitlife_window.cu's: step s reads
// what step s - 1 published in buffer (s - 1) & 1 and publishes into s & 1,
// then one block barrier; warp edges and strip ghosts alternate two
// buffers per refresh, and one cluster barrier per strip refresh suffices
// (the first also waits on a relaxed arrive made at the start, so every
// block of the cluster runs before any of its shared memory is written).
//
// Boards that no cluster of at most 16 blocks of 512 threads holds in
// registers (more than 512 word rows, or wider than 16 strips of 16 warps)
// take the one-block geometry: one block of 1024 threads with the whole
// board double-buffered in shared memory (bitlife_common.cuh:
// resident_steps).
//
// The cluster step (the kernel, its layout and launch configuration) lives
// in bitlife_vmem_cluster.cuh, which bitlife_vmem_batch.cu shares: there a
// stack of boards runs one cluster a board; here the stack is one board.
//
// The launch geometry (strips, cluster, g, RT, tau; RT = 0 for the
// one-block form) is the caller's: ops/bitlife.py:vmem_launch_geometry
// chooses it from the board's shape. The entry checks that it is legal and
// that the card can place one cluster (cudaOccupancyMaxActiveClusters),
// and returns a code of its own (below) otherwise; nothing here falls back
// to another geometry. Gate: 2 x 4 bytes per word within the 227 KB a
// block may use (bitlife.py:fits_vmem_packed).
#include <cuda_runtime.h>

#include "bitlife_common.cuh"
#include "bitlife_vmem_cluster.cuh"

namespace {

using namespace vmem_cluster;

// The one-block geometry: the whole board double-buffered in one block's
// shared memory.
__global__ void __launch_bounds__(kOneBlockThreads)
bitlife_vmem_kernel(const uint32_t* __restrict__ in, uint32_t* __restrict__ out,
                    int nw, int nx, int ny, int steps) {
  extern __shared__ uint32_t smem[];
  bitlife::resident_steps(in, out, smem, nw, nx, ny, steps);
}

const void* kernel_ptr(int rt, bool full) {
  return rt == 0 ? reinterpret_cast<const void*>(bitlife_vmem_kernel)
                 : reinterpret_cast<const void*>(kernel_for(rt, full));
}

int check_board(int nw, int nx, int ny, int steps) {
  if (ny < 0 || nx < 1 || nw != (ny + 33) / 32 || steps < 0) return kErrShape;
  return 0;
}

// Checks the board and the geometry, configures the launch and asks the
// card how many clusters of it it can place at once; returns 0 or an error
// code.
int prepare(int nw, int nx, int ny, int steps, int strips, int cluster,
            int g, int rt, int tau, cudaStream_t stream, Layout* lay,
            cudaLaunchConfig_t* cfg, cudaLaunchAttribute* attr,
            int* clusters) {
  int rc = check_board(nw, nx, ny, steps);
  if (rc) return rc;
  rc = layout(nw, nx, strips, cluster, g, rt, tau, lay);
  if (rc) return rc;
  const void* fn = kernel_ptr(rt, lay->full);
  rc = configure(fn, *lay, strips, cluster, 1, stream, cfg, attr);
  if (rc) return rc;
  return max_active_clusters(fn, *cfg, cluster, clusters);
}

}  // namespace

// Advance the (nw, nx) packed board `in` by `steps` steps into `out` on
// `stream`, over `strips` blocks of one cluster of `cluster` with `g` ghost
// columns per side, `rt` rows per thread and `tau` copied lanes per warp
// side (rt = 0: the one-block geometry, strips = cluster = 1, g = tau =
// 0). Returns 0, kErrShape (nw is not n_words(ny), or an extent or the
// step count is out of range), kErrGeometry (an illegal geometry),
// kErrShared (its shared memory does not fit a block), kErrCluster (the
// card cannot place one cluster of it), or the CUDA error code of an
// attribute call, the occupancy query or the launch.
extern "C" int bitlife_vmem(const void* in, void* out, int nw, int nx, int ny,
                            int steps, int strips, int cluster, int g, int rt,
                            int tau, void* stream) {
  Layout lay;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  int clusters = 0;
  int rc = prepare(nw, nx, ny, steps, strips, cluster, g, rt, tau,
                   static_cast<cudaStream_t>(stream), &lay, &cfg, &attr,
                   &clusters);
  if (rc) return rc;
  if (clusters < 1) return kErrCluster;
  cudaError_t e;
  if (rt == 0) {
    e = cudaLaunchKernelEx(&cfg, bitlife_vmem_kernel,
                           static_cast<const uint32_t*>(in),
                           static_cast<uint32_t*>(out), nw, nx, ny, steps);
  } else {
    Args a{static_cast<const uint32_t*>(in), static_cast<uint32_t*>(out),
           nw, nx, ny, steps, 1, strips, g, tau, lay.P, lay.nq,
           lay.off_vert, lay.off_lo, lay.off_edge, lay.off_ghost};
    e = cudaLaunchKernelEx(&cfg, kernel_for(rt, lay.full), a);
  }
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

// What the CUDA runtime reports for the kernel and launch that
// bitlife_vmem would make with these arguments: out[0] registers a
// thread, out[1] local (spilled) bytes a thread, out[2] static and out[3]
// dynamic shared bytes a block, out[4] the clusters the card can hold at
// once (cudaOccupancyMaxActiveClusters), out[5] threads a block. Returns
// what bitlife_vmem would return before its occupancy check.
extern "C" int bitlife_vmem_attributes(int nw, int nx, int ny, int strips,
                                       int cluster, int g, int rt, int tau,
                                       int* out) {
  Layout lay;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  int clusters = 0;
  int rc = prepare(nw, nx, ny, 0, strips, cluster, g, rt, tau, nullptr, &lay,
                   &cfg, &attr, &clusters);
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

extern "C" const char* bitlife_vmem_error(int code) {
  if (code == kErrShape)
    return "the packed board is not (n_words(ny), nx) words with nx >= 1, "
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
