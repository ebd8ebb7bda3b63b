// pool_lanes: the resident-session pool's lane IO on a board-sliced slab
// (P, ny, nx) of 32-bit words, bit l % 32 of plane l / 32 holding lane l's
// whole board (the layout bitlife_bitsliced.cu steps).
//
// Replaces no Pallas kernel. The JAX package's pool runs XLA programs
// (mpi_and_open_mp_tpu/serve/pool.py:191-208): _lane_write_jit and
// _lane_read_jit. Its masked step, _pool_step_jit, is the tail mode of
// bitlife_bitsliced.cu (entry bitlife_bitsliced_pool). Two entry points:
//
// pool_lane_write(slab, board, plane, bit): one 0/1 uint8 board into bit
//   `bit` of plane `plane`, in place.
// pool_lane_read(slab, plane, bit, out): that bit of every word of the
//   plane as a (ny, nx) uint8 board.
//
// Bound on the H100 (NVIDIA H100 80GB HBM3 at 700 W: 3.35 TB/s of device
// memory): bytes. A lane write reads a word and a byte and writes a word, a
// read reads a word and writes a byte. Each is under the launch floor at
// the pool's sizes (about 1.6 us, measured by chip_smoke.py on that card),
// so the design is the simple one: a thread a word, a block of 256 words.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
// Codes of the entry points' own checks (CUDA's error codes are positive).
constexpr int kErrExtent = -2;
constexpr int kErrLane = -3;

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
    return "planes below 1 or a plane extent below 1 or too big";
  if (code == kErrLane) return "plane or bit outside the slab";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
