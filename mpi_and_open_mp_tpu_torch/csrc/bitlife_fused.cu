// bitlife_fused: k <= 128 fused Life steps of a big bit-packed board (or
// one shard of it) from its halo-extended frame, each row band's column
// strips on a thread-block cluster and a column's words in registers.
//
// Replaces the TPU kernel mpi_and_open_mp_tpu/ops/bitlife.py:
// _fused_tiles_kernel (built by make_fused_stepper), which serves the
// aligned big-board runner life_run_fused_bits, the padded-frame runner
// life_run_frame_bits and the sharded plans' "tiled" mode. The input `ext`
// is the (nw + 2h, W + 2hx) frame that the host extended with h torus-wrap
// word rows per side (h = 4 words = 128 bit rows) and, where the plan has
// them, hx wrap or exchanged columns per side; the output is the (nw, W)
// interior after k steps. Input and output are different buffers.
//
// Bound on the H100: integer logic, at least 17 SHF/LOP3 per word and step
// (chip_smoke.py:OPS_PER_WORD_STEP); device memory is read and written
// once a launch (a 10000^2 frame is 13 MB, 0.008 ms at 3.35 TB/s against
// 0.41 ms of logic for 128 steps). One block a plan tile, its window in
// shared memory, would step 2.0-3.0x the useful words (the y halo and 128
// wall columns a side of every 2-D tile) at three shared-memory loads and a
// store a word and a block barrier a step. What this design does about
// the bound:
//
// * Bands and tiles. A launch cuts the interior's nw word rows into
//   `bands` row bands. A band's window is its rows plus the h halo words
//   above and below that `ext` already holds, rounded up to P * RT rows
//   (rows past the frame read 0). Junk enters at a window's top and bottom
//   edges, one bit row a step, so k <= 32 h keeps the band's rows exact.
//   In x a band is one tile, the whole frame width W + 2hx (the ring over
//   it wraps as the frame does: with hx == 0 that is the torus, exactly;
//   with hx > 0 the wrap's junk walks through the hx wall columns), or,
//   where one cluster cannot hold the width, `tiles` 2-D tiles of W / tiles
//   interior columns, each carrying `wall` >= k columns a side read modulo
//   the frame width.
// * Strips on a cluster. A tile is cut into `strips` column strips, one
//   block (CTA) each, that form a ring: each holds its strip plus g ghost
//   columns a side, and every g steps pushes its first and last g owned
//   columns into its neighbours' ghost buffers (st.shared::cluster through
//   map_shared_rank) behind one barrier.cluster arrive.release /
//   wait.acquire, so the ring wraps exactly at the tile's edge and only 2g
//   columns a strip are stepped twice. Where g >= k (ghost zones) no
//   refresh is needed and the strips need no cluster. A strip of one is a
//   ring with itself: it pushes into its own ghosts behind a block barrier.
// * The step from registers. A thread owns one local column and RT
//   consecutive words of it (P segments a column). Its y neighbours are
//   funnel shifts of its own words and one word from the segment above and
//   below; each column's 3-cell sums go to both side columns by
//   __shfl_up/down_sync, into bitlife_common.cuh:count_rule unchanged. A
//   warp of a multi-warp row owns 32 - 2 tau lanes; its tau lanes a side
//   copy the neighbouring warps' columns from shared memory every tau
//   steps. Segments trade their top and bottom words through shared memory
//   every step behind one block barrier (none with one segment).
//
// Barrier order, double buffers and the ghost pushes are those of
// bitlife_window.cu and bitlife_vmem_cluster.cuh: a thread writing a
// buffer has passed the barrier after which every reader of its last
// contents is done; the first refresh's wait pairs with a relaxed arrive
// made at the start, so every block of a cluster runs before any of its
// shared memory is written; no push follows a block's last wait.
//
// The launch geometry (bands, tiles, wall, strips, cluster, g, RT, tau) is
// the caller's: ops/bitlife.py:fused_launch_geometry chooses it from the
// frame. The entry checks that it is legal and covers the frame, and that
// the card can place one cluster of it (cudaOccupancyMaxActiveClusters),
// and returns a code of its own (below) otherwise; nothing here falls back
// to another geometry.
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <mutex>

#include "bitlife_common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxThreads = 512;
constexpr int kMaxSharedBytes = 232448;
constexpr int kMaxSteps = 128;
constexpr int kMaxCluster = 16;
// Codes of the entry point's own checks (CUDA's error codes are positive).
constexpr int kErrSteps = -1;
constexpr int kErrShared = -2;
constexpr int kErrGeometry = -3;
constexpr int kErrCluster = -4;

struct Args {
  const uint32_t* ext;
  uint32_t* out;
  int nw, W, E, h, k;      // interior, frame width W + 2hx, halo, steps
  int bands, tiles, wall;  // row bands, tiles a band, wall columns a side
  int strips, g, tau, P, nq, exchange;
  // Offsets in words of the shared-memory arrays (see Layout).
  int off_edge, off_ghost;
};

// The derived geometry of one launch; mirrors ops/bitlife.py:
// fused_geometry's FusedGeometry.
struct Layout {
  int P, nq, threads, exchange;
  int off_edge, off_ghost;
  size_t smem;
};

__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

template <int RT>
__device__ __forceinline__ void copy_words(uint32_t* dst,
                                           const uint32_t (&m)[RT]) {
#pragma unroll
  for (int i = 0; i < RT; ++i) dst[i] = m[i];
}

template <int RT>
__device__ __forceinline__ void load_words(uint32_t (&m)[RT],
                                           const uint32_t* src) {
#pragma unroll
  for (int i = 0; i < RT; ++i) m[i] = src[i];
}

// Where a thread sits in its block: segment p of P, warp q of nq in the
// segment's row, lane, local column, and whether it owns that column.
struct Place {
  int P, p, nq, q, lane, col, tcols, tau;
  bool owner;
};

// What an owner leaves in shared memory for other threads after a step:
// its segment's top and bottom words every step (the segments above and
// below read them), and, at a warp refresh, all its words if it is one of
// the tau columns beside a copy range of the warp before or after.
template <int RT>
__device__ __forceinline__ void publish(const Place& t,
                                        const uint32_t (&m)[RT], uint2* vert,
                                        uint32_t* edge, int vb,
                                        bool warp_refresh, int eb) {
  if (!t.owner) return;
  if (t.P > 1) vert[(vb * t.P + t.p) * t.tcols + t.col] =
      make_uint2(m[0], m[RT - 1]);
  if (warp_refresh) {
    if (t.lane < 2 * t.tau)  // read by the warp before
      copy_words(edge + ((((eb * 2) * t.P + t.p) * t.nq + t.q) * t.tau +
                         t.lane - t.tau) * RT, m);
    if (t.lane >= 32 - 2 * t.tau)  // read by the warp after
      copy_words(edge + ((((eb * 2 + 1) * t.P + t.p) * t.nq + t.q) * t.tau +
                         t.lane - (32 - 2 * t.tau)) * RT, m);
  }
}

template <int RT>
__global__ void __launch_bounds__(kMaxThreads)
bitlife_fused_kernel(const Args a) {
  extern __shared__ uint32_t smem[];
  // vert [2][P][32 nq] of (top, bottom) word pairs (at 0);
  // edge [2][2][P][nq][tau][RT] (at a.off_edge);
  // ghost [2][2][g][P][RT] (at a.off_ghost).
  uint2* vert = reinterpret_cast<uint2*>(smem);
  uint32_t* edge = smem + a.off_edge;
  uint32_t* ghost = smem + a.off_ghost;
  const int S = a.strips, g = a.g, P = a.P, nq = a.nq, tau = a.tau;
  const int rank = blockIdx.x % S, win = blockIdx.x / S;
  const int band = win / a.tiles, tile = win - band * a.tiles;
  // The band's interior rows [b0, b1) and the tile's interior columns
  // [t0, t1); the tile's window is Ct columns from frame column x0.
  const int b0 = band * a.nw / a.bands, b1 = (band + 1) * a.nw / a.bands;
  const int t0 = tile * a.W / a.tiles, t1 = (tile + 1) * a.W / a.tiles;
  const int Ct = t1 - t0 + 2 * a.wall;
  const int x0 = (a.E - a.W) / 2 + t0 - a.wall;  // hx + t0 - wall
  const int c0 = rank * Ct / S, w = (rank + 1) * Ct / S - c0;
  const int L = w + 2 * g;
  const int tcols = 32 * nq;
  const int p = threadIdx.x / tcols, t = threadIdx.x - p * tcols;
  const int q = t >> 5, lane = t & 31;
  // Local column of this thread (window column c0 - g + col, mod Ct). A
  // warp of a multi-warp row owns its lanes [tau, 32 - tau); the tau lanes
  // on each side copy the neighbouring warps' columns.
  const int col = nq == 1 ? lane : (32 - 2 * tau) * q - tau + lane;
  const bool valid = col >= 0 && col < L;
  const bool owner =
      valid && (nq == 1 || (lane >= tau && lane < 32 - tau));
  const bool copy = valid && !owner;
  const int r0 = p * RT;
  const int pa = p == 0 ? P - 1 : p - 1, pb = p == P - 1 ? 0 : p + 1;
  const Place me{P, p, nq, q, lane, col, tcols, tau, owner};

  uint32_t m[RT];
  {
    int cw = (c0 - g + col) % Ct;
    cw = cw < 0 ? cw + Ct : cw;
    int x = (x0 + cw) % a.E;
    x = x < 0 ? x + a.E : x;
    const int rows = a.nw + 2 * a.h;
    const uint32_t* src = a.ext + static_cast<size_t>(b0 + r0) * a.E + x;
#pragma unroll
    for (int i = 0; i < RT; ++i)
      m[i] = (valid && b0 + r0 + i < rows)
                 ? src[static_cast<size_t>(i) * a.E]
                 : 0u;
  }

  // A strip of one pushes into its own ghosts: a block barrier orders that.
  const bool ring = S > 1;
  if (a.exchange && ring) cluster_arrive_relaxed();
  if (P > 1) {
    publish(me, m, vert, edge, 0, false, 0);
    __syncthreads();
  }

  const unsigned full = 0xffffffffu;
  // Steps since the last warp and strip refresh, and their buffers.
  int since_w = 0, since_g = 0, eb = 0, fb = 0;
  for (int s = 1; s <= a.k; ++s) {
    // The window's top and bottom segments read each other's words: junk,
    // which walks in one bit row a step through the h halo words.
    uint32_t above = m[RT - 1], below = m[0];
    if (P > 1 && valid) {
      const int rb = (s - 1) & 1;
      above = vert[(rb * P + pa) * tcols + col].y;
      below = vert[(rb * P + pb) * tcols + col].x;
    }
    // One step of the column, word by word: y neighbours by funnel shift,
    // the 3-cell sum (s0, s1) shared with both side columns by shuffle, the
    // centre's sum without itself (up ^ dn, up & dn).
    uint32_t prev = above;
#pragma unroll
    for (int i = 0; i < RT; ++i) {
      const uint32_t cur = m[i];
      const uint32_t nxt = i + 1 < RT ? m[i + 1 < RT ? i + 1 : i] : below;
      const uint32_t dn = __funnelshift_l(prev, cur, 1);
      const uint32_t up = __funnelshift_r(cur, nxt, 1);
      const uint32_t x = up ^ dn, y = up & dn;
      const uint32_t s0 = x ^ cur, s1 = y | (x & cur);
      const uint32_t l0 = __shfl_up_sync(full, s0, 1);
      const uint32_t l1 = __shfl_up_sync(full, s1, 1);
      const uint32_t q0 = __shfl_down_sync(full, s0, 1);
      const uint32_t q1 = __shfl_down_sync(full, s1, 1);
      m[i] = bitlife::count_rule(l0, l1, q0, q1, x, y, cur);
      prev = cur;
    }
    const int vb = s & 1;
    const bool warp_refresh = nq > 1 && ++since_w == tau && s < a.k;
    if (warp_refresh) {
      since_w = 0;
      eb ^= 1;
    }
    if (a.exchange && ++since_g == g && s < a.k) {
      // Refresh the strip's ghosts from the neighbouring strips of the ring.
      if (ring && s == g) cluster_wait();  // pairs with the relaxed arrive
      since_g = 0;
      fb ^= 1;
      if (owner) {
        cg::cluster_group cluster = cg::this_cluster();
        uint32_t* left = ghost + (((fb * 2 + 1) * g + col - g) * P + p) * RT;
        uint32_t* right =
            ghost + (((fb * 2) * g + col - (L - 2 * g)) * P + p) * RT;
        if (col >= g && col < 2 * g)
          copy_words(ring ? cluster.map_shared_rank(
                                left, static_cast<unsigned>(
                                          rank == 0 ? S - 1 : rank - 1))
                          : left,
                     m);
        if (col >= L - 2 * g && col < L - g)
          copy_words(ring ? cluster.map_shared_rank(
                                right, static_cast<unsigned>(
                                           rank == S - 1 ? 0 : rank + 1))
                          : right,
                     m);
      }
      const bool ghost_col = col < g || col >= L - g;
      if (ring) {
        __syncwarp();
        cluster_arrive();
      }
      // What the refresh does not overwrite is published while the pushes
      // are in flight.
      if (!ghost_col) publish(me, m, vert, edge, vb, warp_refresh, eb);
      if (ring) {
        __syncwarp();
        cluster_wait();
      } else {
        __syncthreads();
      }
      if (owner && ghost_col) {
        load_words(m, ghost + (((fb * 2 + (col >= g)) * g +
                                (col < g ? col : col - (L - g))) * P + p) * RT);
        publish(me, m, vert, edge, vb, warp_refresh, eb);
      }
    } else {
      publish(me, m, vert, edge, vb, warp_refresh, eb);
    }
    if (P > 1 || warp_refresh) __syncthreads();
    if (warp_refresh && copy) {
      // Lanes [0, tau) copy the warp before, lanes [32 - tau, 32) the warp
      // after.
      if (lane < tau)
        load_words(m, edge + ((((eb * 2 + 1) * P + p) * nq + q - 1) * tau +
                              lane) * RT);
      else
        load_words(m, edge + ((((eb * 2) * P + p) * nq + q + 1) * tau +
                              lane - (32 - tau)) * RT);
    }
  }

  // The strip's own columns inside the tile's interior, the band's rows.
  if (owner && col >= g && col < g + w) {
    const int cw = c0 + col - g;
    if (cw >= a.wall && cw < Ct - a.wall) {
      uint32_t* dst = a.out + t0 + (cw - a.wall);
#pragma unroll
      for (int i = 0; i < RT; ++i) {
        const int r = b0 + r0 + i - a.h;  // interior row
        if (r >= b0 && r < b1) dst[static_cast<size_t>(r) * a.W] = m[i];
      }
    }
  }
}

using KernelFn = void (*)(const Args);

// The rows-per-thread values compiled: ops/bitlife.py:FUSED_ROWS_PER_THREAD.
KernelFn kernel_for(int rt) {
  switch (rt) {
    case 4: return bitlife_fused_kernel<4>;
    case 8: return bitlife_fused_kernel<8>;
    case 12: return bitlife_fused_kernel<12>;
    case 16: return bitlife_fused_kernel<16>;
    case 20: return bitlife_fused_kernel<20>;
    case 24: return bitlife_fused_kernel<24>;
    case 32: return bitlife_fused_kernel<32>;
    case 40: return bitlife_fused_kernel<40>;
    case 48: return bitlife_fused_kernel<48>;
    default: return nullptr;
  }
}

int check_frame(int nw, int W, int h, int hx, int k) {
  const int x_steps = hx > 0 ? hx : kMaxSteps;
  const int k_max = 32 * h < x_steps ? 32 * h : x_steps;
  if (nw < 1 || W < 1 || h < 1 || hx < 0 || k < 0 || k > k_max)
    return kErrSteps;
  return 0;
}

// Checks the geometry against the (nw, W) interior of a frame with halo h
// and hx, for k steps, and fills `lay`; returns 0 or kErrGeometry /
// kErrShared.
int layout(int nw, int W, int h, int hx, int k, int bands, int tiles,
           int wall, int strips, int cluster, int g, int rt, int tau,
           Layout* lay) {
  if (kernel_for(rt) == nullptr || bands < 1 || bands > nw || tiles < 1 ||
      tiles > W || strips < 1 || strips > kMaxCluster || g < 1 || tau < 1 ||
      tau > 15)
    return kErrGeometry;
  // One tile is the frame's width (its walls are the frame's hx); 2-D
  // tiles carry at least k wall columns a side.
  if (tiles == 1 ? wall != hx : wall < k) return kErrGeometry;
  // The narrowest and widest tile windows.
  const int cmin = W / tiles + 2 * wall;
  const int cmax = (W + tiles - 1) / tiles + 2 * wall;
  if (strips > cmin) return kErrGeometry;
  const int exchange = g < k;
  // A strip's ghosts are refreshed at a warp refresh; exchanged ghosts
  // come from one neighbour's strip, at least floor(cmin / strips) wide,
  // and the cluster is the tile's strips.
  if (exchange &&
      (g % tau || cluster != strips || cmin / strips < g))
    return kErrGeometry;
  if (!exchange && cluster != 1) return kErrGeometry;
  // The tallest band's window fits P segments of rt rows.
  const int rows = (nw + bands - 1) / bands + 2 * h;
  const int P = (rows + rt - 1) / rt;
  const int lmax = (cmax + strips - 1) / strips + 2 * g;
  const int nq = lmax <= 32 ? 1 : (lmax + 31 - 2 * tau) / (32 - 2 * tau);
  const int threads = P * 32 * nq;
  if (threads > kMaxThreads) return kErrGeometry;
  lay->P = P;
  lay->nq = nq;
  lay->threads = threads;
  lay->exchange = exchange;
  const int vert = P > 1 ? 2 * P * 32 * nq * 2 : 0;
  lay->off_edge = vert;
  const int edge = nq > 1 ? 2 * 2 * P * nq * tau * rt : 0;
  lay->off_ghost = vert + edge;
  const int ghost = exchange ? 2 * 2 * g * P * rt : 0;
  lay->smem = static_cast<size_t>(vert + edge + ghost) * sizeof(uint32_t);
  if (lay->smem > static_cast<size_t>(kMaxSharedBytes)) return kErrShared;
  return 0;
}

// Sets the kernel's attributes and fills the launch configuration: a grid
// of bands x tiles x strips blocks, clusters of `cluster` along x.
int configure(KernelFn fn, const Layout& lay, int blocks, int cluster,
              cudaStream_t stream, cudaLaunchConfig_t* cfg,
              cudaLaunchAttribute* attr) {
  cudaError_t e;
  if (lay.smem > 48 * 1024) {
    e = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(lay.smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  if (cluster > 8) {
    e = cudaFuncSetAttribute(fn, cudaFuncAttributeNonPortableClusterSizeAllowed,
                             1);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  *cfg = cudaLaunchConfig_t{};
  cfg->gridDim = dim3(static_cast<unsigned>(blocks));
  cfg->blockDim = dim3(lay.threads);
  cfg->dynamicSmemBytes = lay.smem;
  cfg->stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = cluster;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg->attrs = attr;
  cfg->numAttrs = 1;
  return 0;
}

// cudaOccupancyMaxActiveClusters of a configuration, asked once per
// kernel, block size, shared memory and cluster size (a host call that
// would otherwise cost every launch).
int max_active_clusters(KernelFn fn, const cudaLaunchConfig_t& cfg,
                        int cluster, int* clusters) {
  struct Entry {
    KernelFn fn;
    unsigned threads;
    size_t smem;
    int cluster, clusters;
  };
  static Entry cache[256];
  static int used = 0;
  static std::mutex mu;
  std::lock_guard<std::mutex> lock(mu);
  for (int i = 0; i < used; ++i) {
    const Entry& c = cache[i];
    if (c.fn == fn && c.threads == cfg.blockDim.x &&
        c.smem == cfg.dynamicSmemBytes && c.cluster == cluster) {
      *clusters = c.clusters;
      return 0;
    }
  }
  cudaError_t e = cudaOccupancyMaxActiveClusters(
      clusters, reinterpret_cast<const void*>(fn), &cfg);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (used < 256)
    cache[used++] = Entry{fn, cfg.blockDim.x, cfg.dynamicSmemBytes, cluster,
                          *clusters};
  return 0;
}

// Checks the frame and the geometry, configures the launch and asks the
// card how many clusters of it it can place at once; returns 0 or an error
// code.
int prepare(int nw, int W, int h, int hx, int k, int bands, int tiles,
            int wall, int strips, int cluster, int g, int rt, int tau,
            cudaStream_t stream, Layout* lay, KernelFn* fn,
            cudaLaunchConfig_t* cfg, cudaLaunchAttribute* attr,
            int* clusters) {
  int rc = check_frame(nw, W, h, hx, k);
  if (rc) return rc;
  rc = layout(nw, W, h, hx, k, bands, tiles, wall, strips, cluster, g, rt,
              tau, lay);
  if (rc) return rc;
  *fn = kernel_for(rt);
  rc = configure(*fn, *lay, bands * tiles * strips, cluster, stream, cfg,
                 attr);
  if (rc) return rc;
  return max_active_clusters(*fn, *cfg, cluster, clusters);
}

}  // namespace

// k fused steps of the (nw + 2h, W + 2hx) frame `ext` into its (nw, W)
// interior `out` on `stream`: `bands` row bands, each of `tiles` tiles
// (`wall` columns a side; hx for one tile), each of `strips` blocks in
// clusters of `cluster` with `g` ghost columns a side, `rt` rows a thread
// and `tau` copied lanes a warp side. Returns 0, kErrSteps (k past the
// halo depth, or bad extents), kErrGeometry (an illegal geometry),
// kErrShared (its shared memory does not fit a block), kErrCluster (the
// card cannot place one cluster of it), or the CUDA error code of an
// attribute call, the occupancy query or the launch.
extern "C" int bitlife_fused(const void* ext, void* out, int nw, int W,
                             int h, int hx, int k, int bands, int tiles,
                             int wall, int strips, int cluster, int g,
                             int rt, int tau, void* stream) {
  Layout lay;
  KernelFn fn = nullptr;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  int clusters = 0;
  int rc = prepare(nw, W, h, hx, k, bands, tiles, wall, strips, cluster, g,
                   rt, tau, static_cast<cudaStream_t>(stream), &lay, &fn,
                   &cfg, &attr, &clusters);
  if (rc) return rc;
  if (clusters < 1) return kErrCluster;
  Args a{static_cast<const uint32_t*>(ext), static_cast<uint32_t*>(out),
         nw, W, W + 2 * hx, h, k, bands, tiles, wall, strips, g, tau,
         lay.P, lay.nq, lay.exchange, lay.off_edge, lay.off_ghost};
  cudaError_t e = cudaLaunchKernelEx(&cfg, fn, a);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

// What the CUDA runtime reports for the kernel and launch that
// bitlife_fused would make with these arguments: out[0] registers a
// thread, out[1] local (spilled) bytes a thread, out[2] static and out[3]
// dynamic shared bytes a block, out[4] the clusters the card can hold at
// once (cudaOccupancyMaxActiveClusters), out[5] threads a block. Returns
// what bitlife_fused would return before its occupancy check.
extern "C" int bitlife_fused_attributes(int nw, int W, int h, int hx, int k,
                                        int bands, int tiles, int wall,
                                        int strips, int cluster, int g,
                                        int rt, int tau, int* out) {
  Layout lay;
  KernelFn fn = nullptr;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  int clusters = 0;
  int rc = prepare(nw, W, h, hx, k, bands, tiles, wall, strips, cluster, g,
                   rt, tau, nullptr, &lay, &fn, &cfg, &attr, &clusters);
  if (rc) return rc;
  cudaFuncAttributes fa;
  cudaError_t e =
      cudaFuncGetAttributes(&fa, reinterpret_cast<const void*>(fn));
  if (e != cudaSuccess) return static_cast<int>(e);
  out[0] = fa.numRegs;
  out[1] = static_cast<int>(fa.localSizeBytes);
  out[2] = static_cast<int>(fa.sharedSizeBytes);
  out[3] = static_cast<int>(lay.smem);
  out[4] = clusters;
  out[5] = lay.threads;
  return 0;
}

extern "C" const char* bitlife_fused_error(int code) {
  if (code == kErrSteps)
    return "k exceeds the frame's halo depth min(32 h, hx or 128), or an "
           "extent is out of range";
  if (code == kErrShared)
    return "the geometry's shared memory does not fit a block's 227 KB";
  if (code == kErrGeometry)
    return "illegal launch geometry: rows per thread not compiled, bands "
           "outside [1, nw], tiles outside [1, W], one tile with a wall "
           "other than hx or 2-D tiles with a wall below k, strips outside "
           "[1, 16] or wider than the narrowest tile, ghosts < 1, copied "
           "lanes tau outside [1, 15], an exchanged ghost wider than a "
           "strip or not a multiple of tau or without a cluster of all the "
           "strips, ghost zones (g >= k) with a cluster, or more than 512 "
           "threads a block";
  if (code == kErrCluster)
    return "the card cannot place one cluster of this geometry "
           "(cudaOccupancyMaxActiveClusters returned 0)";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
