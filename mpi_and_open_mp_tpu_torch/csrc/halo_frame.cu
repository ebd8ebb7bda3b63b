// halo_frame: every shard's ghost-padded frame, corners included, in one
// launch over the stacked shards of one card.
//
// Replaces the TPU kernel mpi_and_open_mp_tpu/parallel/haloplan.py:
// _rdma_edge_pair.kernel (its pallas_call is at :309) on the RDMA rung's
// coupled rounds. There each round moves the y edge pair by remote copy,
// then the x edge pair of the y-padded block, so that the diagonal corners
// ride the second copy, and the round concatenates the ghosts beside each
// shard's cells. What that delivers is the frame: for shard (i, j) of the
// stack (py, px, *C, h, w) (parallel/mesh.py), the (h + 2d, w + 2d) block
//   frame[r][q] = shard(i + dy, j + dx)[row][col],
// with dy = -1 (row = h - d + r) for r < d, 0 (row = r - d) in the body and
// +1 (row = r - h - d) below it, and dx, col the same along q. Here every
// shard lives on one card, so the frame is one gather: no edge pair, no
// second phase and no concatenation. The launch boundary stands in for the
// TPU kernel's barrier semaphore, as in halo_edge_pair.cu.
//
// Each shard's nine sources (itself and its eight neighbours) come from a
// table of element offsets, int64 [9][shards], row 3 (dy + 1) + (dx + 1).
// ops/native_halo.py builds it on the host once per geometry and keeps it
// on the card. A layout's unsharded axis (x on row, y on col) is a 1-shard
// ring there: the shard is its own neighbour, the local wrap. A mesh across
// cards can later put peer pointers in its place without a new kernel.
//
// Grid (bands, shards, channels): one block of 8 warps owns a band of 8
// output rows of one (shard, channel) plane, one warp a row. The source
// shard and row are fixed once per output row; the row is three runs of
// d left-ghost, w body and d right-ghost elements, each from one source
// row. The block is read through its strides (channel axes merged into
// one, as halo_edge_pair merges them); the frame is contiguous. Elements of
// 1, 2, 4 and 8 bytes are copied as raw bytes.
//
// Bound on the H100: device memory. Each block element is read once and
// each frame element written once, over 3.35 TB/s; there is no arithmetic.
// What the design does about it: a run stores whole 16-byte words once the
// destination reaches a 16-byte boundary (a few elements first and last,
// one a lane), and loads them as one 16-byte load where the source is
// aligned alike, two 8-byte or four 4-byte loads where it is aligned to 8
// or 4, and else five aligned 4-byte words funnel-shifted into four (bytes
// and 2-byte elements). A warp keeps four 16-byte loads a lane in flight on
// wide rows. On short rows (the main path's shards: at most 64 words a
// run) a lane loads everything it moves in the row's three runs before it
// stores any of it, so the row is one trip to memory, not one a run and
// piece. A column-strided block (sw != 1) is copied element by element.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kWarps = 8;  // output rows of a band: one warp a row
constexpr int kThreads = 32 * kWarps;
constexpr int kMaxGridYZ = 65535;  // shards (gridDim.y), channels (.z)
// Codes of the entry point's own checks (CUDA's error codes are positive).
constexpr int kErrElemSize = -1;
constexpr int kErrExtent = -2;

struct Geometry {
  int shards, h, w, d;
  long long sc, sr, sw;  // element strides: merged channel, row, column
};

// One run of a row: n contiguous elements from src to dst, cut into
// `head` elements before dst's first 16-byte boundary, `chunks` whole
// 16-byte words from there, and the elements from `tail` on; `mis` is the
// source's offset from a 16-byte boundary where the words start.
struct Run {
  const char* s;  // source of the first word
  uint4* t;       // destination of the first word (16-byte aligned)
  int n, head, chunks, tail, mis;
};

template <typename T>
__device__ __forceinline__ Run plan_run(const T* src, T* dst, int n) {
  constexpr int E = sizeof(T);
  Run r;
  r.n = n;
  r.head = static_cast<int>((16 - (reinterpret_cast<uintptr_t>(dst) & 15)) &
                           15) / E;
  if (r.head > n) r.head = n;
  r.chunks = (n - r.head) * E / 16;
  r.tail = r.head + r.chunks * 16 / E;
  r.s = reinterpret_cast<const char*>(src + r.head);
  r.t = reinterpret_cast<uint4*>(dst + r.head);
  r.mis = static_cast<int>(reinterpret_cast<uintptr_t>(r.s) & 15);
  return r;
}

// Word c of a run: one 16-byte load where the source is aligned alike, two
// 8-byte or four 4-byte loads where it is aligned to 8 or 4, else the five
// aligned 4-byte words holding bytes [16c, 16c + 16) of s (each holds at
// least one of them, as mis % 4 != 0) shifted right by the source's offset
// inside its word (little-endian).
__device__ __forceinline__ uint4 load_word(const char* __restrict__ s,
                                           int mis, int c) {
  if (mis == 0) return reinterpret_cast<const uint4*>(s)[c];
  if ((mis & 7) == 0) {
    const uint2* v = reinterpret_cast<const uint2*>(s) + 2 * c;
    const uint2 a = v[0], b = v[1];
    return make_uint4(a.x, a.y, b.x, b.y);
  }
  if ((mis & 3) == 0) {
    const uint32_t* v = reinterpret_cast<const uint32_t*>(s) + 4 * c;
    return make_uint4(v[0], v[1], v[2], v[3]);
  }
  const uint32_t* v = reinterpret_cast<const uint32_t*>(
                          reinterpret_cast<uintptr_t>(s) &
                          ~static_cast<uintptr_t>(3)) +
                      4 * c;
  const unsigned sh = 8u * (mis & 3);
  const uint32_t w0 = v[0], w1 = v[1], w2 = v[2], w3 = v[3], w4 = v[4];
  return make_uint4(__funnelshift_r(w0, w1, sh), __funnelshift_r(w1, w2, sh),
                    __funnelshift_r(w2, w3, sh), __funnelshift_r(w3, w4, sh));
}

// One warp copies a run of any length: head and tail elements one a lane,
// the words in batches of four a lane, then one.
template <typename T>
__device__ __forceinline__ void copy_run(const T* __restrict__ src,
                                         T* __restrict__ dst, const Run& r,
                                         int lane) {
  for (int q = lane; q < r.head; q += 32) dst[q] = src[q];
  for (int q = r.tail + lane; q < r.n; q += 32) dst[q] = src[q];
  int c = lane;
  for (; c + 96 < r.chunks; c += 128) {
    const uint4 a = load_word(r.s, r.mis, c);
    const uint4 b = load_word(r.s, r.mis, c + 32);
    const uint4 e = load_word(r.s, r.mis, c + 64);
    const uint4 f = load_word(r.s, r.mis, c + 96);
    r.t[c] = a;
    r.t[c + 32] = b;
    r.t[c + 64] = e;
    r.t[c + 96] = f;
  }
  for (; c < r.chunks; c += 32) r.t[c] = load_word(r.s, r.mis, c);
}

// A short row (every run of at most kShortWords words a lane): a lane
// loads its head and tail elements and its words of all three runs, then
// stores them, so that the row costs one trip to memory and back.
constexpr int kShortWords = 2;

template <typename T>
__device__ __forceinline__ void copy_short_row(const T* const (&src)[3],
                                               T* const (&dst)[3],
                                               const Run (&r)[3], int lane) {
  T hv[3], tv[3];
  uint4 wv[3][kShortWords];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    if (lane < r[k].head) hv[k] = src[k][lane];
    if (r[k].tail + lane < r[k].n) tv[k] = src[k][r[k].tail + lane];
#pragma unroll
    for (int j = 0; j < kShortWords; ++j)
      if (lane + 32 * j < r[k].chunks)
        wv[k][j] = load_word(r[k].s, r[k].mis, lane + 32 * j);
  }
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    if (lane < r[k].head) dst[k][lane] = hv[k];
    if (r[k].tail + lane < r[k].n) dst[k][r[k].tail + lane] = tv[k];
#pragma unroll
    for (int j = 0; j < kShortWords; ++j)
      if (lane + 32 * j < r[k].chunks) r[k].t[lane + 32 * j] = wv[k][j];
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
halo_frame_kernel(const T* __restrict__ src, T* __restrict__ dst,
                  const long long* __restrict__ table, Geometry g) {
  const int H = g.h + 2 * g.d;
  const int r = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (r >= H) return;
  const int lane = threadIdx.x & 31;
  const int s = blockIdx.y;
  const int ch = blockIdx.z;
  int dy, row;
  if (r < g.d) {
    dy = 0;
    row = g.h - g.d + r;
  } else if (r < g.h + g.d) {
    dy = 1;
    row = r - g.d;
  } else {
    dy = 2;
    row = r - g.h - g.d;
  }
  const long long W = g.w + 2LL * g.d;
  T* out = dst + ((static_cast<long long>(s) * gridDim.z + ch) * H + r) * W;
  const long long at = ch * g.sc + row * g.sr;
  const long long* from = table + 3LL * dy * g.shards + s;
  const T* const in[3] = {src + from[0] + at + (g.w - g.d) * g.sw,
                          src + from[g.shards] + at,
                          src + from[2LL * g.shards] + at};
  T* const to[3] = {out, out + g.d, out + g.d + g.w};
  if (g.sw != 1) {  // a column-strided block: element by element
    const long long n[3] = {g.d, g.w, g.d};
#pragma unroll
    for (int k = 0; k < 3; ++k)
      for (long long q = lane; q < n[k]; q += 32) to[k][q] = in[k][q * g.sw];
    return;
  }
  const Run runs[3] = {plan_run(in[0], to[0], g.d), plan_run(in[1], to[1], g.w),
                       plan_run(in[2], to[2], g.d)};
  if (runs[0].chunks <= 32 * kShortWords && runs[1].chunks <= 32 * kShortWords &&
      runs[2].chunks <= 32 * kShortWords) {
    copy_short_row(in, to, runs, lane);
    return;
  }
#pragma unroll
  for (int k = 0; k < 3; ++k) copy_run(in[k], to[k], runs[k], lane);
}

template <typename T>
int launch(const void* src, void* dst, const void* table, int channels,
           const Geometry& g, cudaStream_t stream) {
  const dim3 grid((g.h + 2 * g.d + kWarps - 1) / kWarps, g.shards, channels);
  halo_frame_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(src), static_cast<T*>(dst),
      static_cast<const long long*>(table), g);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// src: the block's base pointer (its element strides sc, sr, sw; shards
// apart by the table's offsets); dst: the contiguous frame (shards,
// channels, h + 2d, w + 2d); table: int64 [9][shards] on the card.
extern "C" int halo_frame(const void* src, void* dst, const void* table,
                          int shards, int channels, int h, int w, int d,
                          long long sc, long long sr, long long sw,
                          int elem_size, void* stream) {
  if (shards < 0 || shards > kMaxGridYZ || channels < 0 ||
      channels > kMaxGridYZ)
    return kErrExtent;
  if (shards == 0 || channels == 0) return 0;
  if (d < 1 || d > h || d > w) return kErrExtent;
  if (elem_size != 1 && elem_size != 2 && elem_size != 4 && elem_size != 8)
    return kErrElemSize;
  // A run's byte counts are ints.
  if (w + 2LL * d > 0x7fffffffLL / elem_size) return kErrExtent;
  const Geometry g{shards, h, w, d, sc, sr, sw};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (elem_size) {
    case 1:
      return launch<uint8_t>(src, dst, table, channels, g, s);
    case 2:
      return launch<uint16_t>(src, dst, table, channels, g, s);
    case 4:
      return launch<uint32_t>(src, dst, table, channels, g, s);
    case 8:
      return launch<unsigned long long>(src, dst, table, channels, g, s);
    default:
      return kErrElemSize;
  }
}

extern "C" const char* halo_frame_error(int code) {
  if (code == kErrElemSize) return "element size must be 1, 2, 4 or 8 bytes";
  if (code == kErrExtent)
    return "shards or channels outside [0, 65535], a depth outside "
           "[1, min(h, w)], or a frame row past 2^31 bytes";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
