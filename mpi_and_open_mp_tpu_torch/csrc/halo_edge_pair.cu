// halo_edge_pair: the ghost-pair exchange of one mesh axis over the stacked
// shards of one card, both directions in one launch.
//
// Replaces the TPU kernel mpi_and_open_mp_tpu/parallel/haloplan.py:
// _rdma_edge_pair.kernel (its pallas_call is at :309). There each device
// signals a barrier semaphore to its two ring neighbours, waits for both,
// then starts two remote copies: its forward edge into the successor's
// first output, its backward edge into the predecessor's second. Here every
// shard lives on one card in one stacked tensor (py, px, *C, hs, ws)
// (parallel/mesh.py), so the exchange is a strided gather. For each shard s
// of the axis ring, with succ and pred the ring neighbours along that axis
// (the other mesh axis is left as it is):
//   from_prev[succ(s)] = fwd[s],   from_next[pred(s)] = bwd[s].
// The launch boundary stands in for the TPU kernel's barrier semaphore:
// stream order makes every shard's edges final before the launch starts,
// and every output complete when it ends. A 1-shard axis is the self-wrap
// (succ = pred = s); on a 2-shard axis succ = pred, and the two directions
// still land in two different outputs.
//
// Each shard's source and destination come from a table of element
// offsets, int64 [4][shards]: the forward and backward edges' offsets from
// their base pointers, then the offsets in from_prev and from_next that
// receive them. ops/native_halo.py builds it on the host once per geometry
// and keeps it on the card. A mesh across cards can later put peer
// pointers in its place without a new kernel.
//
// Edges are read in place through their strides: the edge is a slice of
// the block, (C, e, ws) rows for y or (C, hs, e) column strips for x,
// ws elements apart. No copy of the slice comes first. The outputs are
// contiguous (shard-major, as the stack). Elements of 1, 2, 4 and 8 bytes
// are copied as raw words: uint8 Life, int32 packed words, float32 heat
// and lenia, two-channel gray_scott.
//
// Bound on the H100: device memory. Each edge element is read once and
// written once (2 x 2 x the edge's bytes over 3.35 TB/s); there is no
// arithmetic. What the design does about it: y edges are whole rows, so a
// warp reads and writes consecutive addresses. A first kernel: one element
// a thread per step of a grid-stride loop, with the row and column found
// by division; x edges cost one memory sector per row. Vector loads, and
// writing the ghosts straight into the padded concatenation that consumes
// them, are later work.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr long long kMaxBlocksX = 1024;
constexpr int kMaxShards = 65535;  // gridDim.y
// Codes of the entry point's own checks (CUDA's error codes are positive).
constexpr int kErrElemSize = -1;
constexpr int kErrExtent = -2;

// Element strides of one edge's channel, row and column dimensions.
struct Edge {
  long long sc, sr, sw;
};

template <typename T>
__global__ void __launch_bounds__(kThreads)
halo_edge_pair_kernel(const T* __restrict__ fwd, const T* __restrict__ bwd,
                      T* __restrict__ prev_out, T* __restrict__ next_out,
                      const long long* __restrict__ table, int shards,
                      long long n, int rows, int cols, Edge ef, Edge eb) {
  const int s = blockIdx.y;
  const int dir = blockIdx.z;  // 0: forward edge, 1: backward edge
  const T* src = (dir ? bwd : fwd) + table[dir * shards + s];
  T* dst = (dir ? next_out : prev_out) + table[(2 + dir) * shards + s];
  const Edge e = dir ? eb : ef;
  const long long plane = static_cast<long long>(rows) * cols;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long t = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       t < n; t += stride) {
    const long long c = t / plane;
    const long long in_plane = t - c * plane;
    const long long r = in_plane / cols;
    const long long w = in_plane - r * cols;
    dst[t] = src[c * e.sc + r * e.sr + w * e.sw];
  }
}

template <typename T>
int launch(const void* fwd, const void* bwd, void* prev_out, void* next_out,
           const void* table, int shards, long long n, int rows, int cols,
           Edge ef, Edge eb, cudaStream_t stream) {
  long long blocks = (n + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocksX) blocks = kMaxBlocksX;
  const dim3 grid(static_cast<unsigned>(blocks), shards, 2);
  halo_edge_pair_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(fwd), static_cast<const T*>(bwd),
      static_cast<T*>(prev_out), static_cast<T*>(next_out),
      static_cast<const long long*>(table), shards, n, rows, cols, ef, eb);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// n: elements of one shard's edge (C * rows * cols); f_* and b_*: the
// element strides of the forward and backward edges' channel (merged),
// row and column dimensions.
extern "C" int halo_edge_pair(const void* fwd, const void* bwd,
                              void* prev_out, void* next_out,
                              const void* table, int shards, long long n,
                              int rows, int cols, long long f_sc,
                              long long f_sr, long long f_sw, long long b_sc,
                              long long b_sr, long long b_sw, int elem_size,
                              void* stream) {
  if (shards < 0 || shards > kMaxShards || n < 0) return kErrExtent;
  if (shards == 0 || n == 0) return 0;
  if (rows < 1 || cols < 1) return kErrExtent;
  const Edge ef{f_sc, f_sr, f_sw};
  const Edge eb{b_sc, b_sr, b_sw};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (elem_size) {
    case 1:
      return launch<uint8_t>(fwd, bwd, prev_out, next_out, table, shards, n,
                             rows, cols, ef, eb, s);
    case 2:
      return launch<uint16_t>(fwd, bwd, prev_out, next_out, table, shards, n,
                              rows, cols, ef, eb, s);
    case 4:
      return launch<uint32_t>(fwd, bwd, prev_out, next_out, table, shards, n,
                              rows, cols, ef, eb, s);
    case 8:
      return launch<unsigned long long>(fwd, bwd, prev_out, next_out, table,
                                        shards, n, rows, cols, ef, eb, s);
    default:
      return kErrElemSize;
  }
}

extern "C" const char* halo_edge_pair_error(int code) {
  if (code == kErrElemSize) return "element size must be 1, 2, 4 or 8 bytes";
  if (code == kErrExtent)
    return "shard count outside [0, 65535], or an edge extent below 1";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
