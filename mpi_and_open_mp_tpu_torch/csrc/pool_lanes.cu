// pool_lanes: the resident-session pool's step tail and lane IO on a
// board-sliced slab (P, ny, nx) of 32-bit words, bit l % 32 of plane l / 32
// holding lane l's whole board (the layout bitlife_bitsliced.cu steps).
//
// Replaces no Pallas kernel. The JAX package's pool runs XLA programs
// (mpi_and_open_mp_tpu/serve/pool.py:153-208): _pool_step_jit's loop of
// jnp.roll steps, then lane_change_bits (ops/bitlife.py:1330) over the
// loop's last pair of consecutive states and a masked merge; _lane_write_jit
// and _lane_read_jit. The port steps s - 1 of a dispatch's s steps with
// bitlife_bitsliced (ops/bitlife.py:bitsliced_steps) and the last one here,
// because the settled word needs the state just before the last step.
// Three entry points:
//
// pool_step_tail(prev, slab, mask, change): one Life step of prev to cur,
//   word by word on the torus (a word's eight neighbours are the whole
//   words at y +- 1, x +- 1, indices modulo the extent, so a 1-row or
//   1-column board reads itself as JAX's rolls do), under count_rule of
//   bitlife_common.cuh. In the same pass each thread writes
//   (cur & mask[p]) | (slab & ~mask[p]) over its own slab word, read just
//   before, and ORs prev ^ cur into change[p], which the wrapper zeroes:
//   a warp OR (__reduce_or_sync), the warps of a block through shared
//   memory, one atomicOr a block. Neighbours come from prev only, never
//   from the slab being written, so the update in place has no hazard.
// pool_lane_write(slab, board, plane, bit): one 0/1 uint8 board into bit
//   `bit` of plane `plane`, in place.
// pool_lane_read(slab, plane, bit, out): that bit of every word of the
//   plane as a (ny, nx) uint8 board.
//
// Bound on the H100 (NVIDIA H100 80GB HBM3 at 700 W: 3.35 TB/s of device
// memory): bytes. The tail reads prev and the slab once and writes the slab
// once, 12 bytes a word (one 500^2 plane: 3 MB, about 0.9 us); a lane write
// reads a word and a byte and writes a word, a read reads a word and writes
// a byte. Each is under the launch floor at the pool's sizes (about 1.6 us,
// measured by chip_smoke.py on that card), so the design is the simple one:
// a thread a word, a block of 256 words of one plane (blockIdx.y is the
// plane), the eight neighbour loads served by L1 and L2.
#include <cuda_runtime.h>

#include <cstdint>

#include "bitlife_common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxPlanes = 65535;  // gridDim.y
// Codes of the entry points' own checks (CUDA's error codes are positive).
constexpr int kErrExtent = -2;
constexpr int kErrLane = -3;

__global__ void __launch_bounds__(kThreads)
pool_step_tail_kernel(const uint32_t* __restrict__ prev,
                      uint32_t* __restrict__ slab,
                      const uint32_t* __restrict__ mask,
                      uint32_t* __restrict__ change, int ny, int nx) {
  __shared__ uint32_t warp_or[kWarps];
  const long long n = static_cast<long long>(ny) * nx;
  const int p = blockIdx.y;
  const long long i = static_cast<long long>(blockIdx.x) * kThreads +
                      threadIdx.x;
  uint32_t diff = 0;
  if (i < n) {
    const uint32_t* w = prev + p * n;
    const int y = static_cast<int>(i / nx);
    const int x = static_cast<int>(i - static_cast<long long>(y) * nx);
    const long long ru = static_cast<long long>(y == 0 ? ny - 1 : y - 1) * nx;
    const long long rm = static_cast<long long>(y) * nx;
    const long long rd = static_cast<long long>(y == ny - 1 ? 0 : y + 1) * nx;
    const int xl = x == 0 ? nx - 1 : x - 1;
    const int xr = x == nx - 1 ? 0 : x + 1;
    const uint32_t up = w[ru + x], dn = w[rd + x], c = w[rm + x];
    // 2-bit sums of the side columns (three cells each) and of the centre
    // column without the centre.
    const uint32_t la = w[ru + xl], lb = w[rm + xl], lc = w[rd + xl];
    const uint32_t ra = w[ru + xr], rb = w[rm + xr], rc = w[rd + xr];
    const uint32_t lx = la ^ lb, rx = ra ^ rb;
    const uint32_t l0 = lx ^ lc, l1 = (la & lb) | (lx & lc);
    const uint32_t r0 = rx ^ rc, r1 = (ra & rb) | (rx & rc);
    const uint32_t cur =
        bitlife::count_rule(l0, l1, r0, r1, up ^ dn, up & dn, c);
    const uint32_t m = mask[p];
    const long long at = p * n + i;
    const uint32_t own = slab[at];
    slab[at] = (cur & m) | (own & ~m);
    diff = c ^ cur;
  }
  diff = __reduce_or_sync(0xffffffffu, diff);
  if ((threadIdx.x & 31) == 0) warp_or[threadIdx.x >> 5] = diff;
  __syncthreads();
  if (threadIdx.x == 0) {
    uint32_t v = 0;
#pragma unroll
    for (int k = 0; k < kWarps; ++k) v |= warp_or[k];
    if (v) atomicOr(change + p, v);
  }
}

__global__ void __launch_bounds__(kThreads)
pool_lane_write_kernel(uint32_t* __restrict__ plane,
                       const uint8_t* __restrict__ board, long long n,
                       int bit) {
  const long long i = static_cast<long long>(blockIdx.x) * kThreads +
                      threadIdx.x;
  if (i >= n) return;
  const uint32_t b = 1u << bit;
  plane[i] = (plane[i] & ~b) | (board[i] ? b : 0u);
}

__global__ void __launch_bounds__(kThreads)
pool_lane_read_kernel(const uint32_t* __restrict__ plane,
                      uint8_t* __restrict__ out, long long n, int bit) {
  const long long i = static_cast<long long>(blockIdx.x) * kThreads +
                      threadIdx.x;
  if (i >= n) return;
  out[i] = static_cast<uint8_t>((plane[i] >> bit) & 1u);
}

unsigned blocks_for(long long n) {
  return static_cast<unsigned>((n + kThreads - 1) / kThreads);
}

bool bad_plane(int ny, int nx) {
  return ny < 1 || nx < 1 ||
         (static_cast<long long>(ny) * nx + kThreads - 1) / kThreads >
             0x7fffffffLL;
}

}  // namespace

// prev, slab: (planes, ny, nx) words; mask, change: `planes` words, change
// zeroed by the caller.
extern "C" int pool_step_tail(const void* prev, void* slab, const void* mask,
                              void* change, int planes, int ny, int nx,
                              void* stream) {
  if (planes < 1 || planes > kMaxPlanes || bad_plane(ny, nx))
    return kErrExtent;
  const long long n = static_cast<long long>(ny) * nx;
  const dim3 grid(blocks_for(n), planes);
  pool_step_tail_kernel<<<grid, kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(prev), static_cast<uint32_t*>(slab),
      static_cast<const uint32_t*>(mask), static_cast<uint32_t*>(change), ny,
      nx);
  return static_cast<int>(cudaGetLastError());
}

// board: (ny, nx) uint8 cells, 0 or not; plane in [0, planes), bit in
// [0, 32).
extern "C" int pool_lane_write(void* slab, const void* board, int planes,
                               int ny, int nx, int plane, int bit,
                               void* stream) {
  if (planes < 1 || bad_plane(ny, nx)) return kErrExtent;
  if (plane < 0 || plane >= planes || bit < 0 || bit > 31) return kErrLane;
  const long long n = static_cast<long long>(ny) * nx;
  pool_lane_write_kernel<<<blocks_for(n), kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<uint32_t*>(slab) + plane * n,
      static_cast<const uint8_t*>(board), n, bit);
  return static_cast<int>(cudaGetLastError());
}

// out: (ny, nx) uint8.
extern "C" int pool_lane_read(const void* slab, void* out, int planes, int ny,
                              int nx, int plane, int bit, void* stream) {
  if (planes < 1 || bad_plane(ny, nx)) return kErrExtent;
  if (plane < 0 || plane >= planes || bit < 0 || bit > 31) return kErrLane;
  const long long n = static_cast<long long>(ny) * nx;
  pool_lane_read_kernel<<<blocks_for(n), kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(slab) + plane * n,
      static_cast<uint8_t*>(out), n, bit);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* pool_lanes_error(int code) {
  if (code == kErrExtent)
    return "planes outside [1, 65535] or a plane extent below 1 or too big";
  if (code == kErrLane) return "plane or bit outside the slab";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
