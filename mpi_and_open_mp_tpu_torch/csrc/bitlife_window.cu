// bitlife_window: k fused Life steps over whole halo-extended shard
// windows of a bit-packed board, each window spread over the column strips
// of a thread-block cluster.
//
// Replaces the TPU kernel mpi_and_open_mp_tpu/ops/bitlife.py:
// make_window_stepper (its kernel), which runs one shard of the sharded
// bitfused path when the shard's whole window fits VMEM: the shard plus
// the ghost words (h per side in y) and ghost columns (hx per side in x)
// that the host exchanged, k <= min(32 h, hx or 128) steps, interior
// written back. Here the input is a stack of S such windows, (S, R, C) =
// (S, nw + 2h, W + 2hx) words, and the output the (S, nw, W) interiors:
// one launch advances every shard of a mesh held on this card, as one
// shard_map program advances every device's shard.
//
// Both axes wrap at the window's edge, as bitlife_common.cuh:window_step
// does: the junk that this feeds in walks one bit row (y) and one column
// (x) per step, so the interior is exact while k <= 32 h and k <= hx; with
// hx == 0 the window's columns are the whole torus and the wrap is exact.
//
// Bound on the H100: integer logic (17 SHF/LOP3 per word and step,
// chip_smoke.py:OPS_PER_WORD_STEP), but a mesh has only a few windows of a
// few thousand words, so at the main paths' shapes the launch is bound by
// the latency of its k dependent steps, not by any rate. What the design
// does about that:
//
// * A window is cut into `strips` column strips, one block (CTA) each, so
//   8 windows occupy up to 128 SMs instead of 8. Each block holds its strip
//   plus g ghost columns per side (L = w + 2g local columns). The strips of
//   a window form a ring: the last strip's right neighbour is the first, so
//   the window still wraps at its own edge.
// * Ghosts come either from device memory once (g >= k: overlapping
//   ghost-zone strips, no traffic between blocks, cluster 1), or, with
//   g < k, from the neighbouring strips every g steps through distributed
//   shared memory: the blocks of a window are one cluster, each pushes its
//   first and last g columns into its neighbours' ghost buffers
//   (st.shared::cluster through map_shared_rank), then one cluster barrier
//   (barrier.cluster.arrive.release ... wait.acquire). Junk enters at the
//   block's local edges, one column per step, so after g steps only the
//   ghosts are spoiled and the strip itself is exact: g - 1 columns per side
//   are recomputed to pay one barrier per g steps, not per step.
// * The step runs from registers. A thread owns one column of its strip,
//   or a segment of RT rows of it (P = ceil(R / RT) segments), the words
//   held in registers. Its y shifts are funnel shifts of its own words
//   (plus one word from the segment above and below); each column computes
//   its 3-cell sums once and hands them to both side columns by
//   __shfl_up/down_sync, so a word costs 2 SHF + 4 LOP + the 11-operation
//   carry-save rule (bitlife_common.cuh:count_rule, unchanged) + 4 SHFL,
//   not life_word's ~49 operations and three shared-memory loads.
// * A warp of a multi-warp row owns 32 - 2 tau columns: its tau lanes on
//   each side copy the neighbouring warps' edge columns from shared memory
//   every tau steps (the owners publish them), and in between the junk
//   that the shuffles hand a warp's edge lanes walks in one lane a step, as
//   at a strip's edge. So the shuffles never cross a warp and the warps of
//   a segment row need a block barrier only every tau steps. A row that
//   fits one warp uses all 32 lanes and no copies. Segments trade their
//   top and bottom words through shared memory every step.
// * The step loop counts steps since each refresh instead of dividing by
//   tau or g: the two integer divisions a step took about a third of a
//   launch at the main paths' windows on an H100.
//
// Barrier order and double buffers. Step s reads the segments' top and
// bottom words that step s - 1 published in buffer (s - 1) & 1 and
// publishes into s & 1, then one block barrier (with one segment, none):
// a thread writing s & 1 at the end of step s has passed the barrier of
// step s - 1, so every reader of that buffer's last contents is done with
// it. Warp edges alternate two buffers per warp refresh, and a writer of
// one has passed the barrier of the refresh before, after which every
// reader of its last contents read them. The ghost buffers alternate the
// same way per strip refresh: pushes of refresh f + 1 land in the buffer
// of refresh f - 1 after the pusher passed the cluster barrier of refresh
// f, which every block reaches only after it loaded refresh f - 1's ghosts.
// So one cluster barrier per refresh suffices. The first refresh also
// waits on a relaxed arrive made at the start (every block of the cluster
// is running before any shared memory of it is written), and no push
// follows a block's last wait, so a block may exit after it. Between a
// refresh's arrive and wait, the columns that the refresh does not
// overwrite publish for the next steps while the pushes are in flight.
//
// The launch geometry (strips, cluster, g, RT, tau) is the caller's:
// ops/bitlife.py:window_launch_geometry chooses it. The entry checks that
// it is legal and that the card can place one cluster
// (cudaOccupancyMaxActiveClusters), and returns a code of its own
// (below) otherwise; nothing here falls back to another geometry.
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
  int R, C, h, hx, k;
  int strips, g, tau, P, nq;
  int exchange;
  // Offsets in words of the shared-memory arrays (see Layout).
  int off_vert, off_edge, off_ghost;
};

// The derived geometry of one launch; mirrors ops/bitlife.py:
// window_geometry's WindowGeometry.
struct Layout {
  int P, nq, threads, exchange;
  int off_vert, off_edge, off_ghost;
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

// c ? a : b as one SELP the compiler cannot fold back into an index:
// a chain of selects by a run-time row count would otherwise become a
// dynamic index into the register array and move it to local memory.
__device__ __forceinline__ uint32_t pick(bool c, uint32_t a, uint32_t b) {
  uint32_t r;
  asm("{\n\t.reg .pred c;\n\tsetp.ne.u32 c, %1, 0;\n\t"
      "selp.b32 %0, %2, %3, c;\n\t}"
      : "=r"(r)
      : "r"(static_cast<uint32_t>(c)), "r"(a), "r"(b));
  return r;
}

// The word of the segment's last row, m[n - 1].
template <int RT>
__device__ __forceinline__ uint32_t last_word(const uint32_t (&m)[RT],
                                              int n) {
  uint32_t b = m[0];
#pragma unroll
  for (int i = 1; i < RT; ++i) b = pick(i == n - 1, m[i], b);
  return b;
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
                                        const uint32_t (&m)[RT], int n,
                                        uint32_t* vert, uint32_t* edge,
                                        int vb, bool warp_refresh, int eb) {
  if (!t.owner) return;
  if (t.P > 1) {
    uint32_t* v = vert + ((vb * t.P + t.p) * t.tcols + t.col) * 2;
    v[0] = m[0];
    v[1] = last_word(m, n);
  }
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
bitlife_window_kernel(const Args a) {
  extern __shared__ uint32_t smem[];
  uint32_t* vert = smem + a.off_vert;    // [2][P][32 nq][2]: top, bottom
  uint32_t* edge = smem + a.off_edge;    // [2][2][P][nq][tau][RT]
  uint32_t* ghost = smem + a.off_ghost;  // [2][2][g][P][RT]
  const int S = a.strips, R = a.R, C = a.C, g = a.g, P = a.P, nq = a.nq;
  const int tau = a.tau;
  const int rank = blockIdx.x % S, win = blockIdx.x / S;
  const int c0 = rank * C / S, w = (rank + 1) * C / S - c0;
  const int L = w + 2 * g;
  const int tcols = 32 * nq;
  const int p = threadIdx.x / tcols, t = threadIdx.x - p * tcols;
  const int q = t >> 5, lane = t & 31;
  // Local column of this thread (global column c0 - g + col, mod C). A
  // warp of a multi-warp row owns its lanes [tau, 32 - tau); the tau lanes
  // on each side copy the neighbouring warps' columns.
  const int col = nq == 1 ? lane : (32 - 2 * tau) * q - tau + lane;
  const bool valid = col >= 0 && col < L;
  const bool owner =
      valid && (nq == 1 || (lane >= tau && lane < 32 - tau));
  const bool copy = valid && !owner;
  const int r0 = p * R / P, n = (p + 1) * R / P - r0;
  const int pa = p == 0 ? P - 1 : p - 1, pb = p == P - 1 ? 0 : p + 1;
  const Place me{P, p, nq, q, lane, col, tcols, tau, owner};

  uint32_t m[RT];
  {
    int cg_ = (c0 - g + col) % C;
    cg_ = cg_ < 0 ? cg_ + C : cg_;
    const uint32_t* src =
        a.ext + static_cast<size_t>(win) * R * C + static_cast<size_t>(r0) * C
        + cg_;
#pragma unroll
    for (int i = 0; i < RT; ++i)
      m[i] = (valid && i < n) ? src[static_cast<size_t>(i) * C] : 0u;
  }

  if (a.exchange) cluster_arrive_relaxed();
  if (P > 1) {
    publish(me, m, n, vert, edge, 0, false, 0);
    __syncthreads();
  }

  const unsigned full = 0xffffffffu;
  // Steps since the last warp and strip refresh, and their buffers.
  int since_w = 0, since_g = 0, eb = 0, fb = 0;
  for (int s = 1; s <= a.k; ++s) {
    uint32_t above = 0, below = 0;
    if (P == 1) {
      above = last_word(m, n);
      below = m[0];
    } else if (valid) {
      const int rb = (s - 1) & 1;
      above = vert[((rb * P + pa) * tcols + col) * 2 + 1];
      below = vert[((rb * P + pb) * tcols + col) * 2];
    }
    // One step of the column, word by word: y neighbours by funnel shift,
    // the 3-cell sum (s0, s1) shared with both side columns by shuffle, the
    // centre's sum without itself (up ^ dn, up & dn).
    uint32_t prev = above;
#pragma unroll
    for (int i = 0; i < RT; ++i) {
      const uint32_t cur = m[i];
      const uint32_t nxt =
          i + 1 < RT ? pick(i + 1 < n, m[i + 1 < RT ? i + 1 : i], below)
                     : below;
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
      if (s == g) cluster_wait();  // pairs with the start's relaxed arrive
      since_g = 0;
      fb ^= 1;
      if (owner) {
        cg::cluster_group cluster = cg::this_cluster();
        if (col >= g && col < 2 * g)
          copy_words(cluster.map_shared_rank(
                         ghost + (((fb * 2 + 1) * g + col - g) * P + p) * RT,
                         static_cast<unsigned>(rank == 0 ? S - 1 : rank - 1)),
                     m);
        if (col >= L - 2 * g && col < L - g)
          copy_words(cluster.map_shared_rank(
                         ghost + (((fb * 2) * g + col - (L - 2 * g)) * P + p)
                                     * RT,
                         static_cast<unsigned>(rank == S - 1 ? 0 : rank + 1)),
                     m);
      }
      const bool ghost_col = col < g || col >= L - g;
      __syncwarp();
      cluster_arrive();
      // What the refresh does not overwrite is published while the pushes
      // are in flight.
      if (!ghost_col) publish(me, m, n, vert, edge, vb, warp_refresh, eb);
      __syncwarp();
      cluster_wait();
      if (owner && ghost_col) {
        load_words(m, ghost + (((fb * 2 + (col >= g)) * g +
                                (col < g ? col : col - (L - g))) * P + p) * RT);
        publish(me, m, n, vert, edge, vb, warp_refresh, eb);
      }
    } else {
      publish(me, m, n, vert, edge, vb, warp_refresh, eb);
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

  // The strip's own columns, interior rows only.
  if (owner && col >= g && col < g + w) {
    const int c = c0 + col - g;
    if (c >= a.hx && c < C - a.hx) {
      const int nw = R - 2 * a.h, W = C - 2 * a.hx;
      uint32_t* dst = a.out + static_cast<size_t>(win) * nw * W + (c - a.hx);
#pragma unroll
      for (int i = 0; i < RT; ++i) {
        const int r = r0 + i;
        if (i < n && r >= a.h && r < R - a.h)
          dst[static_cast<size_t>(r - a.h) * W] = m[i];
      }
    }
  }
}

using KernelFn = void (*)(const Args);

// The rows-per-thread values compiled: ops/bitlife.py:WINDOW_ROWS_PER_THREAD.
KernelFn kernel_for(int rt) {
  switch (rt) {
    case 4: return bitlife_window_kernel<4>;
    case 6: return bitlife_window_kernel<6>;
    case 8: return bitlife_window_kernel<8>;
    case 10: return bitlife_window_kernel<10>;
    case 12: return bitlife_window_kernel<12>;
    case 16: return bitlife_window_kernel<16>;
    case 20: return bitlife_window_kernel<20>;
    case 24: return bitlife_window_kernel<24>;
    case 32: return bitlife_window_kernel<32>;
    default: return nullptr;
  }
}

// Checks the geometry against the window and fills `lay`; returns 0 or
// kErrGeometry / kErrShared.
int layout(int R, int C, int k, int strips, int cluster, int g, int rt,
           int tau, Layout* lay) {
  if (kernel_for(rt) == nullptr || strips < 1 || strips > C || g < 1 ||
      tau < 1 || tau > 15)
    return kErrGeometry;
  const int exchange = g < k;
  // A strip's ghosts are refreshed at a warp refresh.
  if (exchange && g % tau) return kErrGeometry;
  // Exchanged ghosts come from one neighbour, whose strip is at least
  // floor(C / strips) wide; the cluster is the window's strips.
  if (exchange && (cluster != strips || C / strips < g)) return kErrGeometry;
  if (cluster != 1 && cluster != strips) return kErrGeometry;
  if (cluster > kMaxCluster) return kErrGeometry;
  const int P = (R + rt - 1) / rt;
  const int lmax = (C + strips - 1) / strips + 2 * g;
  const int nq = lmax <= 32 ? 1 : (lmax + 31 - 2 * tau) / (32 - 2 * tau);
  const int threads = P * 32 * nq;
  if (threads > kMaxThreads) return kErrGeometry;
  lay->P = P;
  lay->nq = nq;
  lay->threads = threads;
  lay->exchange = exchange;
  lay->off_vert = 0;
  const int vert = P > 1 ? 2 * P * 32 * nq * 2 : 0;
  lay->off_edge = vert;
  const int edge = nq > 1 ? 2 * 2 * P * nq * tau * rt : 0;
  lay->off_ghost = vert + edge;
  const int ghost = exchange ? 2 * 2 * g * P * rt : 0;
  lay->smem = static_cast<size_t>(vert + edge + ghost) * sizeof(uint32_t);
  if (lay->smem > static_cast<size_t>(kMaxSharedBytes)) return kErrShared;
  return 0;
}

// Sets the kernel's attributes and fills the launch configuration.
int configure(KernelFn fn, const Layout& lay, int shards, int strips,
              int cluster, cudaStream_t stream, cudaLaunchConfig_t* cfg,
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
  cfg->gridDim = dim3(static_cast<unsigned>(shards) * strips);
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
  static Entry cache[64];
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
  if (used < 64)
    cache[used++] = Entry{fn, cfg.blockDim.x, cfg.dynamicSmemBytes, cluster,
                          *clusters};
  return 0;
}

int check_window(int shards, int nw, int W, int h, int hx, int k) {
  const int x_steps = hx > 0 ? hx : kMaxSteps;
  const int k_max = 32 * h < x_steps ? 32 * h : x_steps;
  if (shards < 0 || nw < 1 || W < 1 || h < 1 || hx < 0 || k < 0 ||
      k > k_max)
    return kErrSteps;
  return 0;
}

}  // namespace

// k fused steps of `shards` stacked (nw + 2h, W + 2hx) windows `ext` into
// their (nw, W) interiors `out` on `stream`, each window over `strips`
// blocks of clusters of `cluster` with `g` ghost columns per side and `rt`
// rows per thread. Returns 0, kErrSteps (k past the halo depth, or bad
// extents), kErrGeometry (an illegal geometry), kErrShared (its shared
// memory does not fit a block), kErrCluster (the card cannot place one
// cluster of it), or the CUDA error code of an attribute call, the
// occupancy query or the launch.
extern "C" int bitlife_window(const void* ext, void* out, int shards, int nw,
                              int W, int h, int hx, int k, int strips,
                              int cluster, int g, int rt, int tau,
                              void* stream) {
  int rc = check_window(shards, nw, W, h, hx, k);
  if (rc) return rc;
  const int R = nw + 2 * h, C = W + 2 * hx;
  Layout lay;
  rc = layout(R, C, k, strips, cluster, g, rt, tau, &lay);
  if (rc) return rc;
  if (shards == 0) return 0;
  KernelFn fn = kernel_for(rt);
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  rc = configure(fn, lay, shards, strips, cluster,
                 static_cast<cudaStream_t>(stream), &cfg, &attr);
  if (rc) return rc;
  int clusters = 0;
  rc = max_active_clusters(fn, cfg, cluster, &clusters);
  if (rc) return rc;
  if (clusters < 1) return kErrCluster;
  Args a{static_cast<const uint32_t*>(ext), static_cast<uint32_t*>(out),
         R, C, h, hx, k, strips, g, tau, lay.P, lay.nq, lay.exchange,
         lay.off_vert, lay.off_edge, lay.off_ghost};
  cudaError_t e = cudaLaunchKernelEx(&cfg, fn, a);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

// What the CUDA runtime reports for the kernel and launch that
// bitlife_window would make with these arguments: out[0] registers a
// thread, out[1] local (spilled) bytes a thread, out[2] static and out[3]
// dynamic shared bytes a block, out[4] the clusters the card can hold at
// once (cudaOccupancyMaxActiveClusters), out[5] threads a block. Returns
// what bitlife_window would return before launching.
extern "C" int bitlife_window_attributes(int shards, int nw, int W, int h,
                                         int hx, int k, int strips,
                                         int cluster, int g, int rt,
                                         int tau, int* out) {
  int rc = check_window(shards, nw, W, h, hx, k);
  if (rc) return rc;
  Layout lay;
  rc = layout(nw + 2 * h, W + 2 * hx, k, strips, cluster, g, rt, tau,
              &lay);
  if (rc) return rc;
  KernelFn fn = kernel_for(rt);
  cudaFuncAttributes fa;
  cudaError_t e = cudaFuncGetAttributes(&fa, reinterpret_cast<const void*>(fn));
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  rc = configure(fn, lay, shards > 0 ? shards : 1, strips, cluster, nullptr,
                 &cfg, &attr);
  if (rc) return rc;
  int clusters = 0;
  rc = max_active_clusters(fn, cfg, cluster, &clusters);
  if (rc) return rc;
  out[0] = fa.numRegs;
  out[1] = static_cast<int>(fa.localSizeBytes);
  out[2] = static_cast<int>(fa.sharedSizeBytes);
  out[3] = static_cast<int>(lay.smem);
  out[4] = clusters;
  out[5] = lay.threads;
  return 0;
}

extern "C" const char* bitlife_window_error(int code) {
  if (code == kErrSteps)
    return "k exceeds the window's halo depth min(32 h, hx or 128), or an "
           "extent is out of range";
  if (code == kErrShared)
    return "the geometry's shared memory does not fit a block's 227 KB";
  if (code == kErrGeometry)
    return "illegal launch geometry: rows per thread not compiled, strips "
           "outside [1, C], ghosts < 1, copied lanes tau outside [1, 15], "
           "an exchanged ghost wider than a strip or not a multiple of tau, "
           "a cluster that is neither 1 nor the strips or above 16, or more "
           "than 512 threads a block";
  if (code == kErrCluster)
    return "the card cannot place one cluster of this geometry "
           "(cudaOccupancyMaxActiveClusters returned 0)";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
