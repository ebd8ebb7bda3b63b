// quadrature: the trapezoid rule for the reference's integrand
// f(x) = sqrt(4 - x^2) over every shard of a 1-D virtual mesh, in two
// launches and one float32 result.
//
// Replaces no Pallas kernel: the JAX package runs this as one jitted
// lax.fori_loop over 2^17-point chunks (mpi_and_open_mp_tpu/ops/
// quadrature.py:75-121, trapezoid_shard_sum and trapezoid_serial, whose
// fori_loops are at :102 and :121). At the reference's N = 10^12
// (launchers/run_integral.sh:12) that is 7.63 M chunks, which plain torch
// would issue as tens of millions of launches, so the chunk evaluation and
// the compensated accumulation are this kernel.
//
// What it computes is the plain version's (ops/quadrature.py). Grid point
// i in [0, n] is (g, r): chunk g = i / CHUNK, lane r = i % CHUNK. It adds
// w * f(x), w = 0.5 at the global points 0 and n and 1 elsewhere, lanes
// past point n masked, at
//   x = (f32(a) + f32(g) * f32(CHUNK h)) + f32(r) * f32(h)
// with the three float32 factors rounded on the host from the double. The
// roundings are JAX's: every product and sum is an __fmul_rn / __fadd_rn,
// which nvcc never contracts into an FMA, and the square root is the
// correctly rounded __fsqrt_rn. Nothing may be built with --use_fast_math:
// it would also fold Kahan's compensation away.
//
// Pass 1 (quadrature_chunk_kernel): one block of 256 threads a chunk, its
// float32 sum written to chunk_sums[g]. A thread takes lanes tid + 256 k,
// in groups of 8 points summed as a tree, each group added to one of eight
// running sums (8 adds each), then a tree over the eight, the warp
// (shuffles) and the block's eight warps. Only chunk 0 and the last chunk
// mask lanes and halve a weight; every other chunk takes the unmasked
// loop.
// Pass 2 (quadrature_kahan_kernel): one block. Warp w takes shards w,
// w + 32, ...; shard k owns chunks [k per, (k + 1) per), chunks past the
// last adding 0.0 (as JAX's masked loop does). Its lanes stage 128 chunk
// sums at a time in shared memory, the next 128 loading while lane 0 runs
// the Kahan chain over these in chunk order. Then thread 0 sums the
// partials in float32 in shard order (JAX's psum) and multiplies by
// f32(h).
//
// A call may take a run of the shards, [first, first + count), and then
// computes only their chunks, [first per, (first + count) per) clipped to
// the grid: the process of a mesh across processes that holds those
// shards (models/integral.py). Pass 2 writes each shard's partial to
// `partials`; the caller gathers every process's partials and sums them in
// shard order in float32, times f32(h), the operations thread 0 does, so
// the value is the one-process call's to the bit.
//
// Bound on the H100: arithmetic. Each point costs one MUFU.RSQ (inside the
// correctly rounded square root) at 16 a clock an SM, and some fifteen
// issued instructions at 128 lanes a clock an SM (chip_smoke.py counts
// them from cuobjdump -sass); the chunk sums are 4 bytes a chunk, nothing
// against device memory. Pass 1 keeps the fixed work off the loop: the
// chunk's base abscissa once a block, r as a float stepped by 256 (no
// integer conversion a point), no mask or weight on interior chunks, a
// tree of 8 points and eight running sums for the latency of the adds.
// Pass 2 is one dependent chain of four float adds a chunk per shard
// (about 60 ms at 10^12 on one shard): the price of JAX's Kahan order,
// which a later design may restructure.
#include <cuda_runtime.h>

namespace {

constexpr int kChunk = 1 << 17;  // points of a chunk (ops/quadrature.py)
constexpr int kThreads = 256;    // pass 1: threads a block
constexpr int kSums = 8;         // pass 1: running sums a thread
constexpr int kGroup = 8;        // pass 1: points summed as a tree
constexpr int kTrips = kChunk / (kThreads * kSums * kGroup);  // 8
constexpr int kWarpsMax = 32;    // pass 2: warps of its one block
constexpr int kTile = 128;       // pass 2: chunk sums a warp stages
constexpr int kPerLane = kTile / 32;
constexpr int kMaxShards = 4096;  // pass 2: partials in shared memory
constexpr long long kMaxChunks = 0x7fffffffLL;  // gridDim.x
// Codes of the entry point's own checks (CUDA's error codes are positive).
constexpr int kErrExtent = -2;

__device__ __forceinline__ float point(float base, float fr, float h) {
  const float x = __fadd_rn(base, __fmul_rn(fr, h));
  const float v = fmaxf(__fsub_rn(4.0f, __fmul_rn(x, x)), 0.0f);
  return __fsqrt_rn(v);
}

__device__ __forceinline__ float block_sum(float s, float* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    s = __fadd_rn(s, __shfl_xor_sync(0xffffffffu, s, o));
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) red[warp] = s;
  __syncthreads();
  s = 0.0f;
  if (warp == 0) {
    s = lane < kThreads / 32 ? red[lane] : 0.0f;
#pragma unroll
    for (int o = 4; o > 0; o >>= 1)
      s = __fadd_rn(s, __shfl_xor_sync(0xffffffffu, s, o));
  }
  return s;
}

// A thread's sum over its 512 lanes tid + 256 k of the chunk: 8 trips of 8
// groups of 8 points, each group summed as a tree and added to its own
// running sum (acc[u] takes group u of every trip), then a tree over the 8.
// Each running sum takes 8 adds, so even a chunk of nearly equal values
// (at N = 10^12 a chunk spans a few float32 abscissae) keeps its rounding
// near the float32 unit. EDGE: weights 0 past point n and 0.5 on the
// global points 0 and n.
template <bool EDGE>
__device__ __forceinline__ float thread_sum(float base, float h, bool first,
                                            bool last, int last_lane) {
  float acc[kSums];
#pragma unroll
  for (int u = 0; u < kSums; ++u) acc[u] = 0.0f;
  float fr = static_cast<float>(threadIdx.x);
  int r = threadIdx.x;
#pragma unroll 1
  for (int trip = 0; trip < kTrips; ++trip) {
#pragma unroll
    for (int u = 0; u < kSums; ++u) {
      float y[kGroup];
#pragma unroll
      for (int j = 0; j < kGroup; ++j) {
        y[j] = point(base, fr, h);
        if (EDGE) {
          const float w = (last && r > last_lane) ? 0.0f
                          : ((first && r == 0) || (last && r == last_lane))
                              ? 0.5f
                              : 1.0f;
          y[j] = __fmul_rn(w, y[j]);
        }
        fr = __fadd_rn(fr, static_cast<float>(kThreads));
        r += kThreads;
      }
      const float grp = __fadd_rn(
          __fadd_rn(__fadd_rn(y[0], y[1]), __fadd_rn(y[2], y[3])),
          __fadd_rn(__fadd_rn(y[4], y[5]), __fadd_rn(y[6], y[7])));
      acc[u] = __fadd_rn(acc[u], grp);
    }
  }
  return __fadd_rn(
      __fadd_rn(__fadd_rn(acc[0], acc[1]), __fadd_rn(acc[2], acc[3])),
      __fadd_rn(__fadd_rn(acc[4], acc[5]), __fadd_rn(acc[6], acc[7])));
}

// RUN: the block's chunk is g0 + blockIdx.x (a run of shards that starts
// past chunk 0); without it g0 is 0 and unread, so a call from chunk 0
// (every one-process call) runs the code it ran before runs existed: the
// offset cost that form 3 registers and ~2 % of its time on the H100.
template <bool RUN>
__global__ void __launch_bounds__(kThreads)
    quadrature_chunk_kernel(float* __restrict__ chunk_sums, long long g0,
                            long long last_chunk, int last_lane, float a,
                            float h, float chunk_h) {
  __shared__ float red[kThreads / 32];
  const long long g = RUN ? g0 + blockIdx.x : blockIdx.x;
  const float base = __fadd_rn(a, __fmul_rn(__ll2float_rn(g), chunk_h));
  // Only the first and the last chunk (one chunk when n < CHUNK) mask
  // lanes and halve weights.
  float s = (g != 0 && g != last_chunk)
                ? thread_sum<false>(base, h, false, false, last_lane)
                : thread_sum<true>(base, h, g == 0, g == last_chunk,
                                   last_lane);
  s = block_sum(s, red);
  if (threadIdx.x == 0) chunk_sums[blockIdx.x] = s;
}

// chunk_sums holds the run's chunks from its first shard's first chunk
// on, n_chunks of them (past the grid's last, none); the block takes the
// run's count shards, partial k for its shard k.
__global__ void quadrature_kahan_kernel(const float* __restrict__ chunk_sums,
                                        float* __restrict__ out,
                                        float* __restrict__ partials,
                                        long long n_chunks, int count,
                                        long long per, float h) {
  __shared__ float stage[kWarpsMax][kTile];
  __shared__ float partial[kMaxShards];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int warps = blockDim.x >> 5;
  float* tile = stage[warp];
  for (int k = warp; k < count; k += warps) {
    const long long first = static_cast<long long>(k) * per;
    float next[kPerLane];
    auto load = [&](long long c0) {
#pragma unroll
      for (int q = 0; q < kPerLane; ++q) {
        const long long c = c0 + lane + 32 * q;
        const long long g = first + c;
        next[q] = (c < per && g < n_chunks) ? chunk_sums[g] : 0.0f;
      }
    };
    load(0);
    float acc = 0.0f, comp = 0.0f;
    for (long long c0 = 0; c0 < per; c0 += kTile) {
#pragma unroll
      for (int q = 0; q < kPerLane; ++q) tile[lane + 32 * q] = next[q];
      __syncwarp();
      load(c0 + kTile);  // in flight while lane 0 runs the chain
      if (lane == 0) {
        const int m = per - c0 < kTile ? static_cast<int>(per - c0) : kTile;
        for (int j = 0; j < m; ++j) {
          const float y = __fsub_rn(tile[j], comp);
          const float t = __fadd_rn(acc, y);
          comp = __fsub_rn(__fsub_rn(t, acc), y);
          acc = t;
        }
      }
      __syncwarp();
    }
    if (lane == 0) partial[k] = partials[k] = acc;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    float total = 0.0f;
    for (int k = 0; k < count; ++k) total = __fadd_rn(total, partial[k]);
    out[0] = __fmul_rn(total, h);
  }
}

}  // namespace

// The chunks of shards [first, first + count): [first per, min((first +
// count) per, n_chunks)), none when that is empty.
static long long run_chunks(long long n_chunks, long long per, int first,
                            int count) {
  const long long g0 = static_cast<long long>(first) * per;
  long long g1 = static_cast<long long>(first + count) * per;
  if (g1 > n_chunks) g1 = n_chunks;
  return g1 > g0 ? g1 - g0 : 0;
}

// Shards [first, first + count) of `shards`. chunk_sums: float32 scratch on
// the card for their chunks (run_chunks of them, at least one);
// partials: float32 [count], each shard's Kahan partial; out: one float32,
// the partials summed in shard order times h. a, h, chunk_h: f32(a),
// f32(h), f32(CHUNK h), rounded on the host. *launched: the kernels this
// call launched (0, 1 when the run holds no chunk, or 2).
extern "C" int quadrature(void* chunk_sums, void* out, void* partials,
                          long long n_chunks, long long last_chunk,
                          int last_lane, int shards, long long per, int first,
                          int count, float a, float h, float chunk_h,
                          void* stream, int* launched) {
  *launched = 0;
  if (n_chunks < 1 || n_chunks > kMaxChunks ||
      last_chunk != n_chunks - 1 || last_lane < 0 || last_lane >= kChunk ||
      shards < 1 || shards > kMaxShards || per < 1 ||
      per * shards < n_chunks || first < 0 || count < 1 ||
      count > shards - first)
    return static_cast<int>(kErrExtent);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long g0 = static_cast<long long>(first) * per;
  const long long chunks = run_chunks(n_chunks, per, first, count);
  cudaError_t err;
  if (chunks) {
    const unsigned grid = static_cast<unsigned>(chunks);
    float* sums = static_cast<float*>(chunk_sums);
    if (g0)
      quadrature_chunk_kernel<true><<<grid, kThreads, 0, s>>>(
          sums, g0, last_chunk, last_lane, a, h, chunk_h);
    else
      quadrature_chunk_kernel<false><<<grid, kThreads, 0, s>>>(
          sums, 0, last_chunk, last_lane, a, h, chunk_h);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    *launched += 1;
  }
  const int warps = count < kWarpsMax ? count : kWarpsMax;
  quadrature_kahan_kernel<<<1, 32 * warps, 0, s>>>(
      static_cast<const float*>(chunk_sums), static_cast<float*>(out),
      static_cast<float*>(partials), chunks, count, per, h);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  *launched += 1;
  return 0;
}

extern "C" const char* quadrature_error(int code) {
  if (code == kErrExtent)
    return "chunks outside [1, 2^31 - 1], shards outside [1, 4096], a "
           "run of shards outside them, or a chunk geometry that does not "
           "cover the grid";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
