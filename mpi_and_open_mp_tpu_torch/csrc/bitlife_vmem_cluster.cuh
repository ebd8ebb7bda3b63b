// The cluster step of the resident packed Life kernels (bitlife_vmem.cu,
// one board; bitlife_vmem_batch.cu, a stack of boards, one cluster each):
// a board spread over the column strips of one thread-block cluster that
// forms a ring over the torus, a column's words in registers. The design
// is described in bitlife_vmem.cu. A launch's grid is (strips, boards):
// blockIdx.x is the block's rank in its board's ring and the board is
// blockIdx.y (plus gridDim.y * blockIdx.z past the grid's y extent of
// 65 535), at offset board * R * C words of the stack; the cluster is
// (strips, 1, 1), so a cluster never spans two boards and a block reads and
// writes its own board's words only.
//
// Beside the kernel: the launch's Layout (layout), its configuration
// (configure) and the clusters the card places at once
// (max_active_clusters), which both entry points share.
#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <mutex>

#include "bitlife_common.cuh"

namespace vmem_cluster {

namespace cg = cooperative_groups;

constexpr int kMaxThreads = 512;
constexpr int kOneBlockThreads = 1024;
constexpr int kMaxSharedBytes = 232448;
constexpr int kMaxCluster = 16;
// The grid's y extent: boards past it go to blockIdx.z.
constexpr int kMaxGridY = 65535;
// Codes of the entry point's own checks (CUDA's error codes are positive).
constexpr int kErrShape = -1;
constexpr int kErrShared = -2;
constexpr int kErrGeometry = -3;
constexpr int kErrCluster = -4;

struct Args {
  const uint32_t* in;
  uint32_t* out;
  int R, C, ny, steps, boards;
  int strips, g, tau, P, nq;
  // Offsets in words of the shared-memory arrays (see Layout).
  int off_vert, off_lo, off_edge, off_ghost;
};

// The derived geometry of one launch; mirrors ops/bitlife.py:
// vmem_geometry's VmemGeometry.
struct Layout {
  int P, nq, threads;
  bool full;  // every segment holds rt words
  int off_vert, off_lo, off_edge, off_ghost;
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

// m[j] for a run-time j in [0, RT).
template <int RT>
__device__ __forceinline__ uint32_t word_at(const uint32_t (&m)[RT], int j) {
  uint32_t b = m[0];
#pragma unroll
  for (int i = 1; i < RT; ++i) b = pick(i == j, m[i], b);
  return b;
}

// m[j] = v for a run-time j in [0, RT).
template <int RT>
__device__ __forceinline__ void set_word(uint32_t (&m)[RT], int j,
                                         uint32_t v) {
#pragma unroll
  for (int i = 0; i < RT; ++i) m[i] = pick(i == j, v, m[i]);
}

// A segment's last word m[n - 1], and setting it: FULL segments (n == RT,
// every segment of the launch) index it at compile time.
template <int RT, bool FULL>
__device__ __forceinline__ uint32_t last_of(const uint32_t (&m)[RT], int n) {
  return FULL ? m[RT - 1] : word_at(m, n - 1);
}

template <int RT, bool FULL>
__device__ __forceinline__ void set_last(uint32_t (&m)[RT], int n,
                                         uint32_t v) {
  if (FULL)
    m[RT - 1] = v;
  else
    set_word(m, n - 1, v);
}

// The word at index j of the last segment that holds position ny: j is
// n - 1 or n - 2 (position ny lies in word R - 1 or R - 2).
template <int RT, bool FULL>
__device__ __forceinline__ uint32_t lo_of(const uint32_t (&m)[RT], int j) {
  return FULL ? pick(j == RT - 1, m[RT - 1], m[RT - 2]) : word_at(m, j);
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
// segment's row, lane, local column, whether it owns that column, its
// segment's word count n, where position ny lies in it (i_lo, used by the
// last segment), and the shared-memory words (offsets from the block's
// base, buffer 0) where it publishes its top and bottom words (pub, the
// second buffer vstride words on) and the word holding position ny (lo,
// the second buffer tcols words on).
struct Place {
  int P, p, nq, q, lane, col, tcols, tau, n, i_lo, pub, vstride, lo;
  bool owner, publish_lo;
};

// What an owner leaves in shared memory for other threads after a step:
// its segment's top and bottom words every step (the segments above and
// below read them) and, where position ny lies in word R - 2, that word
// (the first segment reads it; in word R - 1 it is the last segment's
// bottom word); at a warp refresh, all its words if it is one of the tau
// columns beside a copy range of the warp before or after.
template <int RT, bool FULL>
__device__ __forceinline__ void publish(const Place& t,
                                        const uint32_t (&m)[RT],
                                        uint32_t* smem, uint32_t* edge,
                                        int vb, bool warp_refresh, int eb) {
  if (!t.owner) return;
  if (t.P > 1) {
    *reinterpret_cast<uint2*>(smem + t.pub + (vb ? t.vstride : 0)) =
        make_uint2(m[0], last_of<RT, FULL>(m, t.n));
    if (t.publish_lo)
      smem[t.lo + (vb ? t.tcols : 0)] = lo_of<RT, FULL>(m, t.i_lo);
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

template <int RT, bool FULL>
__global__ void __launch_bounds__(kMaxThreads, 1)
bitlife_vmem_cluster_kernel(const Args a) {
  extern __shared__ uint32_t smem[];
  // vert [2][P][32 nq][2]: top, bottom (at a.off_vert); lo [2][32 nq]: the
  // word holding position ny (at a.off_lo).
  uint32_t* edge = smem + a.off_edge;    // [2][2][P][nq][tau][RT]
  uint32_t* ghost = smem + a.off_ghost;  // [2][2][g][P][RT]
  const int S = a.strips, R = a.R, C = a.C, g = a.g, P = a.P, nq = a.nq;
  const int tau = a.tau;
  // The board: y (and z past the grid's y extent) of the grid. A cluster
  // is one board's strips, so its blocks leave together, before any
  // cluster barrier.
  const size_t board = blockIdx.y + static_cast<size_t>(gridDim.y) * blockIdx.z;
  if (board >= static_cast<size_t>(a.boards)) return;
  const size_t base = board * R * C;
  const int rank = blockIdx.x;  // x is the board's cluster
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
  const int r0 = p * R / P, n = FULL ? RT : (p + 1) * R / P - r0;
  const int pa = p == 0 ? P - 1 : p - 1, pb = p == P - 1 ? 0 : p + 1;
  // The torus ghosts: position ny (word w_lo, bit b_lo) and the bit of
  // position ny + 1 in word R - 1.
  const int w_lo = a.ny >> 5, b_lo = a.ny & 31;
  const uint32_t hi = 1u << ((a.ny + 1) & 31);
  const bool first = p == 0, last = p == P - 1;
  const bool lo_is_bottom = w_lo == R - 1;
  // The segments' traded words this thread reads (buffer 0) and the
  // words between the two buffers.
  const int vstride = P * tcols * 2;
  const int v_above = a.off_vert + (pa * tcols + col) * 2 + 1;
  const int v_below = a.off_vert + (pb * tcols + col) * 2;
  const Place me{P, p, nq, q, lane, col, tcols, tau, n, w_lo - r0,
                 a.off_vert + (p * tcols + col) * 2, vstride,
                 a.off_lo + col, owner, last && !lo_is_bottom};

  uint32_t m[RT];
  {
    int cg_ = (c0 - g + col) % C;
    cg_ = cg_ < 0 ? cg_ + C : cg_;
    const uint32_t* src = a.in + base + static_cast<size_t>(r0) * C + cg_;
#pragma unroll
    for (int i = 0; i < RT; ++i)
      m[i] = (valid && (FULL || i < n)) ? src[static_cast<size_t>(i) * C]
                                        : 0u;
  }

  const bool exchange = g < a.steps;
  // A strip of one pushes into its own ghosts: a block barrier orders that.
  const bool ring = S > 1;
  if (exchange && ring) cluster_arrive_relaxed();
  if (P > 1) {
    publish<RT, FULL>(me, m, smem, edge, 0, false, 0);
    __syncthreads();
  }

  const unsigned full = 0xffffffffu;
  // Steps since the last warp and strip refresh, and their buffers.
  int since_w = 0, since_g = 0, eb = 0, fb = 0;
  for (int s = 1; s <= a.steps; ++s) {
    uint32_t above = 0, below = 0;
    if (P == 1) {
      // The whole column: refresh the ghosts in order, then wrap.
      m[0] = (m[0] & ~1u) | ((lo_of<RT, FULL>(m, w_lo) >> b_lo) & 1u);
      above = (last_of<RT, FULL>(m, n) & ~hi) | ((m[0] & 2u) ? hi : 0u);
      set_last<RT, FULL>(m, n, above);
      below = m[0];
    } else if (valid) {
      const bool rb = (s - 1) & 1;
      above = smem[v_above + (rb ? vstride : 0)];
      below = smem[v_below + (rb ? vstride : 0)];
      // Segment 0 holds word 0 and reads word R - 1 above it; the last
      // segment holds word R - 1 and reads word 0 below it.
      if (first) {
        const uint32_t src =
            lo_is_bottom ? above : smem[me.lo + (rb ? tcols : 0)];
        const uint32_t top = (m[0] & 2u) ? hi : 0u;
        m[0] = (m[0] & ~1u) | ((src >> b_lo) & 1u);
        above = (above & ~hi) | top;
      }
      if (last) {
        const uint32_t ny_bit = (lo_of<RT, FULL>(m, me.i_lo) >> b_lo) & 1u;
        const uint32_t top = (below & 2u) ? hi : 0u;
        set_last<RT, FULL>(m, n, (last_of<RT, FULL>(m, n) & ~hi) | top);
        below = (below & ~1u) | ny_bit;
      }
    }
    // One step of the column, word by word: y neighbours by funnel shift,
    // the 3-cell sum (s0, s1) shared with both side columns by shuffle, the
    // centre's sum without itself (up ^ dn, up & dn).
    uint32_t prev = above;
#pragma unroll
    for (int i = 0; i < RT; ++i) {
      const uint32_t cur = m[i];
      const uint32_t nxt =
          i + 1 >= RT ? below
          : FULL      ? m[i + 1 < RT ? i + 1 : i]
                      : pick(i + 1 < n, m[i + 1 < RT ? i + 1 : i], below);
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
    const bool warp_refresh = nq > 1 && ++since_w == tau && s < a.steps;
    if (warp_refresh) {
      since_w = 0;
      eb ^= 1;
    }
    if (exchange && ++since_g == g && s < a.steps) {
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
      if (!ghost_col)
        publish<RT, FULL>(me, m, smem, edge, vb, warp_refresh, eb);
      if (ring) {
        __syncwarp();
        cluster_wait();
      } else {
        __syncthreads();
      }
      if (owner && ghost_col) {
        load_words(m, ghost + (((fb * 2 + (col >= g)) * g +
                                (col < g ? col : col - (L - g))) * P + p) * RT);
        publish<RT, FULL>(me, m, smem, edge, vb, warp_refresh, eb);
      }
    } else {
      publish<RT, FULL>(me, m, smem, edge, vb, warp_refresh, eb);
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

  // The strip's own columns, every row.
  if (owner && col >= g && col < g + w) {
    uint32_t* dst =
        a.out + base + static_cast<size_t>(r0) * C + (c0 + col - g);
#pragma unroll
    for (int i = 0; i < RT; ++i)
      if (FULL || i < n) dst[static_cast<size_t>(i) * C] = m[i];
  }
}

using KernelFn = void (*)(const Args);

// The rows-per-thread values compiled (ops/bitlife.py:
// WINDOW_ROWS_PER_THREAD), each in two forms: every segment full (R ==
// P * RT, FULL) or not.
inline KernelFn kernel_for(int rt, bool full) {
#define VMEM_KERNEL_CASE(RT) \
  case RT:                   \
    return full ? &bitlife_vmem_cluster_kernel<RT, true> \
                : &bitlife_vmem_cluster_kernel<RT, false>;
  switch (rt) {
    VMEM_KERNEL_CASE(4)
    VMEM_KERNEL_CASE(6)
    VMEM_KERNEL_CASE(8)
    VMEM_KERNEL_CASE(10)
    VMEM_KERNEL_CASE(12)
    VMEM_KERNEL_CASE(16)
    VMEM_KERNEL_CASE(20)
    VMEM_KERNEL_CASE(24)
    VMEM_KERNEL_CASE(32)
    default: return nullptr;
  }
#undef VMEM_KERNEL_CASE
}

// Checks the geometry against the (R, C) board and fills `lay` (rt = 0:
// the one-block geometry, one block of kOneBlockThreads a board with the
// board double-buffered in shared memory); returns 0 or kErrGeometry /
// kErrShared.
inline int layout(int R, int C, int strips, int cluster, int g, int rt,
                  int tau, Layout* lay) {
  *lay = Layout{};
  if (rt == 0) {
    if (strips != 1 || cluster != 1 || g != 0 || tau != 0)
      return kErrGeometry;
    lay->P = 1;
    lay->nq = 1;
    lay->threads = kOneBlockThreads;
    lay->smem = 2ull * R * C * sizeof(uint32_t);
  } else {
    if (kernel_for(rt, false) == nullptr || strips < 1 || strips > C ||
        strips > kMaxCluster || cluster != strips || g < 1 ||
        C / strips < g || tau < 1 || tau > 15 || g % tau)
      return kErrGeometry;
    const int P = (R + rt - 1) / rt;
    const int lmax = (C + strips - 1) / strips + 2 * g;
    const int nq = lmax <= 32 ? 1 : (lmax + 31 - 2 * tau) / (32 - 2 * tau);
    const int threads = P * 32 * nq;
    if (threads > kMaxThreads) return kErrGeometry;
    lay->P = P;
    lay->nq = nq;
    lay->threads = threads;
    lay->full = R == P * rt;
    const int vert = P > 1 ? 2 * P * 32 * nq * 2 : 0;
    const int lo = P > 1 ? 2 * 32 * nq : 0;
    const int edge = nq > 1 ? 2 * 2 * P * nq * tau * rt : 0;
    const int ghost = 2 * 2 * g * P * rt;
    lay->off_lo = vert;
    lay->off_edge = vert + lo;
    lay->off_ghost = vert + lo + edge;
    lay->smem = static_cast<size_t>(vert + lo + edge + ghost) *
                sizeof(uint32_t);
  }
  if (lay->smem > static_cast<size_t>(kMaxSharedBytes)) return kErrShared;
  return 0;
}

// Sets the kernel's attributes and fills the launch configuration of
// `boards` boards: the grid (strips, boards), its y extent capped at
// kMaxGridY with the rest of the boards along z.
inline int configure(const void* fn, const Layout& lay, int strips,
                     int cluster, int boards, cudaStream_t stream,
                     cudaLaunchConfig_t* cfg, cudaLaunchAttribute* attr) {
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
  const int gy = boards < kMaxGridY ? boards : kMaxGridY;
  cfg->gridDim = dim3(static_cast<unsigned>(strips), static_cast<unsigned>(gy),
                      static_cast<unsigned>((boards + gy - 1) / gy));
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
inline int max_active_clusters(const void* fn,
                               const cudaLaunchConfig_t& cfg, int cluster,
                               int* clusters) {
  struct Entry {
    const void* fn;
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
  cudaError_t e = cudaOccupancyMaxActiveClusters(clusters, fn, &cfg);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (used < 64)
    cache[used++] = Entry{fn, cfg.blockDim.x, cfg.dynamicSmemBytes, cluster,
                          *clusters};
  return 0;
}

}  // namespace vmem_cluster
