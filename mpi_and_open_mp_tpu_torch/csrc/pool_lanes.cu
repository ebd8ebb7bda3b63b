// pool_lanes: the resident-session pool's lane IO between a board in
// page-locked host memory and a board-sliced slab (P, ny, nx) of 32-bit
// words on the card, bit l % 32 of plane l / 32 holding lane l's whole
// board (the layout bitlife_bitsliced.cu steps).
//
// Replaces no Pallas kernel. The JAX package's pool runs XLA programs
// (mpi_and_open_mp_tpu/serve/pool.py:191-208): _lane_write_jit and
// _lane_read_jit, one host board in or out a call. Its masked step,
// _pool_step_jit, is the tail mode of bitlife_bitsliced.cu (entry
// bitlife_bitsliced_pool). Two entry points:
//
// pool_lane_write(slab, board, ...): one board of ny * nx bytes (0 or not)
//   in page-locked host memory into bit `bit` of plane `plane`, in place.
// pool_lane_read(slab, out, ...): that bit of every word of the plane as
//   ny * nx bytes of 0/1 into page-locked host memory.
//
// Each kernel reads or writes the host board itself, through the device
// pointer of the page-locked buffer (cudaHostGetDevicePointer; unified
// addressing maps it): no copy launch and no staging tensor on the card,
// one launch an op. A pageable or device buffer has no such pointer and is
// refused (kErrHost).
//
// Bound on the H100 (NVIDIA H100 80GB HBM3 at 700 W): the board crossing
// PCIe, 1 B a cell at the link's rate (PCIe 5.0 x16, 63 GB/s a direction
// nominal, or the 64 MiB pinned copy's rate chip_smoke.py phase 26
// measures, whichever is higher), against the plane's HBM traffic at 3.35
// TB/s (the write reads and writes a word, 8 B a cell; the read reads one,
// 4 B). At the pool's sizes the link term is the larger (500^2: 250 000 B,
// about 4 us). So the design is for the link: a thread takes 16 cells, one
// 16-byte host access (a warp 512 contiguous bytes; host reads bypass the
// caches, __ldcv, host writes go through, __stwt), and the plane's 16 words
// as four 16-byte accesses. The plane is one flat run of ny * nx cells; the
// chunk past the last multiple of 16, and every chunk when the host buffer
// or the plane does not start on 16 bytes, goes cell by cell.
//
// Grid: one 16-cell chunk a thread, 256 threads a block (500^2: 62 blocks,
// 48^2: 1), the whole board's accesses in flight at once. Chosen by a sweep
// of grid caps (each thread then looping over chunks) on an NVIDIA H100
// 80GB HBM3 at 700 W, two runs, the kernel's own records on a page-locked
// board the host left alone: at 500^2 the write took 0.0125 and 0.0080 ms
// at 62 blocks, 0.0118 and 0.0075 at 32, 0.0120 and 0.0092 at 16, 0.0171
// and 0.0147 at 8 and 0.107 and 0.095 at 1; the read 0.0070 and 0.0068 at
// 62, 0.0073 and 0.0070 at 32 and 0.0219 and 0.0217 at 1. Past ~16 blocks
// the link, not the grid, sets the time (the write's reads from host memory
// reach 20-31 GB/s, the read's writes 36-37 GB/s), and 32 and 62 differ by
// less than the runs do; at 48^2 every cap is the one block, 0.0025-0.0031
// ms. So the grid is the full one.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
// Cells a thread: one 16-byte host access.
constexpr int kCells = 16;
// Codes of the entry points' own checks (CUDA's error codes are positive).
constexpr int kErrExtent = -2;
constexpr int kErrLane = -3;
constexpr int kErrHost = -4;

__device__ __forceinline__ uint32_t put(uint32_t word, uint32_t cell,
                                        uint32_t b) {
  return cell ? (word | b) : (word & ~b);
}

__device__ __forceinline__ uint32_t get4(uint4 w, int bit) {
  return ((w.x >> bit) & 1u) | (((w.y >> bit) & 1u) << 8) |
         (((w.z >> bit) & 1u) << 16) | (((w.w >> bit) & 1u) << 24);
}

// board: the host board's device pointer.
__global__ void __launch_bounds__(kThreads)
pool_lane_write_kernel(uint32_t* __restrict__ plane,
                       const uint8_t* __restrict__ board, long long n,
                       int bit, int aligned) {
  const uint32_t b = 1u << bit;
  const long long i0 =
      (static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x) * kCells;
  if (i0 >= n) return;
  if (aligned && i0 + kCells <= n) {
    const uint4 cells = __ldcv(reinterpret_cast<const uint4*>(board + i0));
    uint4* w = reinterpret_cast<uint4*>(plane + i0);
    uint4 v[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) v[q] = w[q];
    const uint32_t by[4] = {cells.x, cells.y, cells.z, cells.w};
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      v[q].x = put(v[q].x, by[q] & 0xffu, b);
      v[q].y = put(v[q].y, (by[q] >> 8) & 0xffu, b);
      v[q].z = put(v[q].z, (by[q] >> 16) & 0xffu, b);
      v[q].w = put(v[q].w, by[q] >> 24, b);
      w[q] = v[q];
    }
  } else {
    const long long end = i0 + kCells < n ? i0 + kCells : n;
    for (long long i = i0; i < end; ++i)
      plane[i] = put(plane[i], __ldcv(board + i), b);
  }
}

// out: the host board's device pointer.
__global__ void __launch_bounds__(kThreads)
pool_lane_read_kernel(const uint32_t* __restrict__ plane,
                      uint8_t* __restrict__ out, long long n, int bit,
                      int aligned) {
  const long long i0 =
      (static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x) * kCells;
  if (i0 >= n) return;
  if (aligned && i0 + kCells <= n) {
    const uint4* w = reinterpret_cast<const uint4*>(plane + i0);
    uint4 v[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) v[q] = w[q];
    __stwt(reinterpret_cast<uint4*>(out + i0),
           make_uint4(get4(v[0], bit), get4(v[1], bit), get4(v[2], bit),
                      get4(v[3], bit)));
  } else {
    const long long end = i0 + kCells < n ? i0 + kCells : n;
    for (long long i = i0; i < end; ++i)
      __stwt(out + i, static_cast<uint8_t>((plane[i] >> bit) & 1u));
  }
}

// Blocks of one 16-cell chunk a thread.
long long grid_of(int ny, int nx) {
  const long long chunks = (static_cast<long long>(ny) * nx + kCells - 1) /
                           kCells;
  return (chunks + kThreads - 1) / kThreads;
}

bool bad_plane(int ny, int nx) {
  return ny < 1 || nx < 1 || grid_of(ny, nx) > 0x7fffffffLL;
}

// The device pointer of page-locked host memory, or nullptr (the failed
// lookup's error cleared: it is not sticky, but cudaGetLastError would
// report it after the launch).
void* mapped(const void* host) {
  void* dev = nullptr;
  if (cudaHostGetDevicePointer(&dev, const_cast<void*>(host), 0) !=
      cudaSuccess) {
    cudaGetLastError();
    return nullptr;
  }
  return dev;
}

int aligned(const void* a, const void* b) {
  return ((reinterpret_cast<uintptr_t>(a) | reinterpret_cast<uintptr_t>(b)) &
          15u) == 0;
}

}  // namespace

// board: (ny, nx) bytes, 0 or not, in page-locked host memory; plane in
// [0, planes), bit in [0, 32).
extern "C" int pool_lane_write(void* slab, const void* board, int planes,
                               int ny, int nx, int plane, int bit,
                               void* stream) {
  if (planes < 1 || bad_plane(ny, nx)) return kErrExtent;
  if (plane < 0 || plane >= planes || bit < 0 || bit > 31) return kErrLane;
  const void* dev = mapped(board);
  if (dev == nullptr) return kErrHost;
  const long long n = static_cast<long long>(ny) * nx;
  uint32_t* words = static_cast<uint32_t*>(slab) + plane * n;
  pool_lane_write_kernel<<<grid_of(ny, nx), kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      words, static_cast<const uint8_t*>(dev), n, bit, aligned(words, dev));
  return static_cast<int>(cudaGetLastError());
}

// out: (ny, nx) bytes in page-locked host memory, written when the stream
// reaches the launch.
extern "C" int pool_lane_read(const void* slab, void* out, int planes, int ny,
                              int nx, int plane, int bit, void* stream) {
  if (planes < 1 || bad_plane(ny, nx)) return kErrExtent;
  if (plane < 0 || plane >= planes || bit < 0 || bit > 31) return kErrLane;
  void* dev = mapped(out);
  if (dev == nullptr) return kErrHost;
  const long long n = static_cast<long long>(ny) * nx;
  const uint32_t* words = static_cast<const uint32_t*>(slab) + plane * n;
  pool_lane_read_kernel<<<grid_of(ny, nx), kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      words, static_cast<uint8_t*>(dev), n, bit, aligned(words, dev));
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* pool_lanes_error(int code) {
  if (code == kErrExtent)
    return "planes below 1 or a plane extent below 1 or too big";
  if (code == kErrLane) return "plane or bit outside the slab";
  if (code == kErrHost)
    return "the host board is not page-locked memory mapped for the card";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
