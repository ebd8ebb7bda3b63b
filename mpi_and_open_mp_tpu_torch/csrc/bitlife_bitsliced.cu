// bitlife_bitsliced: Life on a board-sliced stack - bit b of plane p's
// word at (y, x) is board 32p + b's cell (y, x) - with each plane's row
// bands spread over the column strips of a thread-block cluster.
//
// Replaces the TPU kernel mpi_and_open_mp_tpu/ops/bitlife.py:
// _bitsliced_kernel (behind life_run_bitsliced_batch). The TPU keeps the
// whole (n_planes, ny, nx) stack in VMEM; a 500x500 plane is 1 MB, past
// the 227 KB a block may use, so here each plane is cut into `bands` row
// bands and each band into `strips` column strips, one block (CTA) each.
// The word at (y, x) of the next state is bitlife_common.cuh:count_rule of
// the eight words around it: no shifts, as a word's bits are 32 boards.
//
// Bound on the H100: integer logic, at least 15 LOP3 per word and step
// (chip_smoke.py:OPS_PER_SLICED_WORD_STEP: each column's 3-word sums are
// shared with both side columns). Device memory (or L2, which holds a
// 64-board 500^2 stack) is read and written once a launch. What the design
// does about the bound:
//
// * A band's window is its rows plus `halo` rows above and below, read
//   modulo ny (the y wrap is exact for any extent, ny < halo included), and
//   the plane's whole width. Junk enters at the window's top and bottom
//   edges, one word row a step, so a launch steps k <= halo steps and writes
//   back the band's own rows. With one band and no halo the window is the
//   plane and its own wrap is the torus's: one launch runs every step.
// * The band's strips form a ring over the torus in x, so the x wrap is
//   exact and only the g ghost columns a side are stepped twice. A block
//   holds its strip plus g ghost columns per side (L = w + 2g local
//   columns), read once from device memory (mod nx). Junk enters at a
//   block's local edges, one column per step, so every g steps each block
//   pushes its first and last g owned columns into its ring neighbours'
//   ghost buffers (st.shared::cluster through map_shared_rank), behind one
//   barrier.cluster arrive.release / wait.acquire. Ghost buffers and
//   barrier order are bitlife_vmem.cu's: two buffers each, the first
//   refresh's wait paired with a relaxed arrive made at the start, so every
//   block of the cluster runs before any of its shared memory is written.
//   A strip of one is a ring with itself (shuffles do not wrap): it pushes
//   into its own ghosts behind a block barrier. Where g >= halo (ghost
//   zones) no launch refreshes at all, and the strips need no cluster.
// * The step runs from registers. A thread owns CT adjacent local columns
//   and RT consecutive words of each (a column takes P = ceil(R / RT)
//   segments of the window's R rows). Each column computes its sums once:
//   the full 3-word sum (a ^ b ^ m, maj(a, b, m)) and the centre-excluded
//   one (a ^ b, a & b). Within a thread the full sums go straight to the
//   neighbouring columns; across threads by __shfl_up/down_sync (4 a word
//   row, whatever CT), then into count_rule, unchanged.
// * Segments trade their top and bottom words through shared memory every
//   step, behind one block barrier (two buffers). A warp of a multi-warp
//   row owns 32 - 2 tau lanes: its tau lanes on each side copy the
//   neighbouring warps' columns (tau * CT of them) from shared memory every
//   tau * CT steps. The step loop counts steps since each refresh.
// * With a halo, R is P * RT (the extra rows join the bottom halo), so
//   every segment is full and a segment's last word has a fixed index. The
//   window of one band and no halo is the plane's ny rows, and a segment's
//   last word is picked by one PTX selp per word (pick), which keeps the
//   register array out of local memory.
//
// The clusters (n_planes x bands of them, the grid) never wait on one
// another, so a stack of more clusters than the card holds at once runs in
// waves. The launch geometry (bands, halo, strips, cluster, g, RT, CT,
// tau) is the caller's: ops/bitlife.py:plan_bitsliced chooses it from the
// stack's shape. The entry checks that it is legal and that the card can
// place one cluster of it (cudaOccupancyMaxActiveClusters), and returns a
// code of its own (below) otherwise; nothing here falls back to another
// geometry. The C entry runs ceil(steps / halo) launches (one without a
// halo), ping-ponging between `out` and `scratch` so that the last writes
// `out`; `in` is never written. Each launch is a programmatic dependent
// launch: it may begin while the one before it on the stream ends, and
// waits (griddepcontrol.wait) for that one's memory before touching device
// memory, which hides much of the gap between the rounds.
//
// The tail mode (TAIL, entry bitlife_bitsliced_pool) is the resident-
// session pool's dispatch: JAX's _pool_step_jit
// (mpi_and_open_mp_tpu/serve/pool.py:169-189), which steps a slab, keeps
// the masked lanes' new words and the others' old ones, and returns each
// plane's change word, lane_change_bits of the last two states. The same
// rounds run; only the last launches the TAIL form, which runs its last
// step after its step loop (tail_step): each word the block writes back
// is stored as soon as it is computed, as (new & mask) | (orig & ~mask),
// orig the call's first input, and its old ^ new ORed into a thread's
// word (junk rows and ghost columns never reach it), which is reduced over
// the block (__reduce_or_sync, the warps through shared memory) into one
// atomicOr a block on the plane's word, zeroed by the entry on the stream
// (cudaMemsetAsync). Bound: one more 4-byte read a word than the plain
// call (orig), and the merge's LOP3 and the change word's XOR and OR a
// word. The plain forms compile as before (their SASS is unchanged).
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <mutex>

#include "bitlife_common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxThreads = 512;
constexpr int kMaxSharedBytes = 232448;
constexpr int kMaxCluster = 16;
// Codes of the entry point's own checks (CUDA's error codes are positive).
constexpr int kErrShape = -1;
constexpr int kErrShared = -2;
constexpr int kErrGeometry = -3;
constexpr int kErrCluster = -4;
constexpr int kErrSteps = -5;
constexpr int kErrAlias = -6;
// The tail mode's static shared memory: a word a warp.
constexpr int kTailSharedBytes = kMaxThreads / 32 * 4;

struct Args {
  const uint32_t* in;
  uint32_t* out;
  int ny, nx, k;       // the plane, and the steps of this launch
  int bands, halo, R;  // bands a plane, halo rows a side, window rows
  int strips, g, tau, P, nq;
  int off_edge, off_ghost;  // word offsets of the shared arrays (vert at 0)
  // Read by the TAIL forms only: the call's first input, whose words the
  // unmasked lanes keep, a lane mask and a change word a plane.
  const uint32_t* orig;
  const uint32_t* mask;
  uint32_t* change;
};

// The derived geometry of one launch; mirrors ops/bitlife.py:
// sliced_geometry's SlicedGeometry.
struct Layout {
  int R, P, nq, threads;
  bool full;
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

// c ? a : b as one SELP the compiler cannot fold back into an index (see
// bitlife_vmem.cu).
__device__ __forceinline__ uint32_t pick(bool c, uint32_t a, uint32_t b) {
  uint32_t r;
  asm("{\n\t.reg .pred c;\n\tsetp.ne.u32 c, %1, 0;\n\t"
      "selp.b32 %0, %2, %3, c;\n\t}"
      : "=r"(r)
      : "r"(static_cast<uint32_t>(c)), "r"(a), "r"(b));
  return r;
}

// A segment's last word m[n - 1]: FULL segments (n == RT) index it at
// compile time, the others pick it by a chain of selects.
template <int RT, bool FULL>
__device__ __forceinline__ uint32_t last_of(const uint32_t (&m)[RT], int n) {
  if (FULL) return m[RT - 1];
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
// segment's row, lane, copied lanes tau a warp side, local columns a
// segment row (tcols), its first local column col0 of the strip's L, its
// segment's word count n, and whether it owns its columns.
struct Place {
  int P, p, nq, q, lane, tau, tcols, col0, L, n;
  bool owner;
};

// What an owner leaves in shared memory after a step: its segment's top
// and bottom words (every step, for the segments above and below) and, at
// a warp refresh, all its words if it is one of the tau units beside a
// copy range of the warp before or after.
template <int RT, int CT, bool FULL>
__device__ __forceinline__ void publish(const Place& t,
                                        const uint32_t (&m)[CT][RT],
                                        uint2* vert, uint32_t* edge, int vb,
                                        bool warp_refresh, int eb) {
  if (!t.owner) return;
  if (t.P > 1) {
#pragma unroll
    for (int c = 0; c < CT; ++c)
      if (t.col0 + c < t.L)
        vert[(vb * t.P + t.p) * t.tcols + t.col0 + c] =
            make_uint2(m[c][0], last_of<RT, FULL>(m[c], t.n));
  }
  if (warp_refresh) {
    const int row = t.p * t.nq + t.q;
    if (t.lane < 2 * t.tau) {  // read by the warp before
      uint32_t* dst = edge + (((eb * 2) * t.P * t.nq + row) * t.tau +
                              t.lane - t.tau) * CT * RT;
#pragma unroll
      for (int c = 0; c < CT; ++c) copy_words(dst + c * RT, m[c]);
    }
    if (t.lane >= 32 - 2 * t.tau) {  // read by the warp after
      uint32_t* dst = edge + (((eb * 2 + 1) * t.P * t.nq + row) * t.tau +
                              t.lane - (32 - 2 * t.tau)) * CT * RT;
#pragma unroll
      for (int c = 0; c < CT; ++c) copy_words(dst + c * RT, m[c]);
    }
  }
}

// The tail mode's last step: the step loop's arithmetic for one step, each
// word that the thread writes back (bit c * RT + i of wb) stored at once
// into plane (row y0 + i, column x0 + c), its masked lanes new and the
// others keep's, and its old ^ new ORed into the word returned. The new
// words are never kept: the step reads only old ones. A copy of the loop's
// body rather than a function both call: with one, the plain forms'
// registers were allocated otherwise (their SASS changed). Out of the loop
// because inside it ptxas hoisted the tests of wb's bits in front of it,
// more predicates than the card's 7 (ptxas error C7600).
template <int RT, int CT, bool FULL>
__device__ __forceinline__ uint32_t tail_step(
    const uint32_t (&m)[CT][RT], const uint32_t (&above)[CT],
    const uint32_t (&below)[CT], int n, uint32_t wb, uint32_t* plane,
    const uint32_t* keep, uint32_t mk, int y0, int x0, int nx) {
  const unsigned full = 0xffffffffu;
  uint32_t diff = 0;
  uint32_t prev[CT];
#pragma unroll
  for (int c = 0; c < CT; ++c) prev[c] = above[c];
#pragma unroll
  for (int i = 0; i < RT; ++i) {
    uint32_t cur[CT], x[CT], y[CT], s0[CT], s1[CT];
#pragma unroll
    for (int c = 0; c < CT; ++c) {
      cur[c] = m[c][i];
      const uint32_t nxt =
          i + 1 >= RT ? below[c]
          : FULL      ? m[c][i + 1 < RT ? i + 1 : i]
                      : pick(i + 1 < n, m[c][i + 1 < RT ? i + 1 : i],
                             below[c]);
      x[c] = prev[c] ^ nxt;
      y[c] = prev[c] & nxt;
      s0[c] = x[c] ^ cur[c];
      s1[c] = y[c] | (x[c] & cur[c]);
    }
    const uint32_t l0 = __shfl_up_sync(full, s0[CT - 1], 1);
    const uint32_t l1 = __shfl_up_sync(full, s1[CT - 1], 1);
    const uint32_t r0_ = __shfl_down_sync(full, s0[0], 1);
    const uint32_t r1_ = __shfl_down_sync(full, s1[0], 1);
#pragma unroll
    for (int c = 0; c < CT; ++c) {
      const uint32_t nw = bitlife::count_rule(
          c == 0 ? l0 : s0[c > 0 ? c - 1 : 0],
          c == 0 ? l1 : s1[c > 0 ? c - 1 : 0],
          c == CT - 1 ? r0_ : s0[c < CT - 1 ? c + 1 : c],
          c == CT - 1 ? r1_ : s1[c < CT - 1 ? c + 1 : c], x[c], y[c],
          cur[c]);
      if ((wb >> (c * RT + i)) & 1u) {
        const size_t at = static_cast<size_t>(y0 + i) * nx + x0 + c;
        plane[at] = (nw & mk) | (keep[at] & ~mk);
        diff |= cur[c] ^ nw;
      }
      prev[c] = cur[c];
    }
  }
  return diff;
}

template <int RT, int CT, bool FULL, bool TAIL>
__global__ void __launch_bounds__(kMaxThreads, 1)
bitlife_bitsliced_kernel(const Args a) {
  extern __shared__ uint32_t smem[];
  // vert [2][P][tcols] of (top, bottom) word pairs (at 0);
  // edge [2][2][P][nq][tau][CT][RT] (at a.off_edge);
  // ghost [2][2][g][P][RT] (at a.off_ghost).
  uint2* vert = reinterpret_cast<uint2*>(smem);
  uint32_t* edge = smem + a.off_edge;
  uint32_t* ghost = smem + a.off_ghost;
  const int S = a.strips, ny = a.ny, nx = a.nx, g = a.g, P = a.P;
  const int nq = a.nq, tau = a.tau, k = a.k;
  const int band = blockIdx.x / S, rank = blockIdx.x - band * S;
  const int c0 = rank * nx / S, w = (rank + 1) * nx / S - c0;
  const int L = w + 2 * g;
  const int b0 = band * ny / a.bands;
  const int rb = (band + 1) * ny / a.bands - b0;
  const int units = 32 * nq, tcols = units * CT;
  const int p = threadIdx.x / units, t = threadIdx.x - p * units;
  const int q = t >> 5, lane = t & 31;
  // The thread's unit of CT local columns (global column c0 - g + col, mod
  // nx). A warp of a multi-warp row owns its lanes [tau, 32 - tau); the
  // tau lanes on each side copy the neighbouring warps' units.
  const int unit = nq == 1 ? lane : (32 - 2 * tau) * q - tau + lane;
  const int col0 = unit * CT;
  const bool in_row = unit >= 0;
  const bool valid = in_row && col0 < L;
  const bool owner = valid && (nq == 1 || (lane >= tau && lane < 32 - tau));
  const bool copy = valid && !owner;
  const int r0 = FULL ? p * RT : p * a.R / P;
  const int n = FULL ? RT : (p + 1) * a.R / P - r0;
  const int pa = p == 0 ? P - 1 : p - 1, pb = p == P - 1 ? 0 : p + 1;
  const int wper = tau * CT;  // steps between warp refreshes

  // Programmatic dependent launch: this grid may start while the launch
  // before it on the stream (the previous round, or whatever wrote `in`)
  // finishes; every global access waits for that one to complete here.
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  uint32_t m[CT][RT];
  {
    const uint32_t* plane =
        a.in + static_cast<size_t>(blockIdx.y) * ny * nx;
    int y0 = (b0 - a.halo + r0) % ny;
    y0 = y0 < 0 ? y0 + ny : y0;
#pragma unroll
    for (int c = 0; c < CT; ++c) {
      const int col = col0 + c;
      int x = (c0 - g + col) % nx;
      x = x < 0 ? x + nx : x;
      const bool ok = in_row && col < L;
#pragma unroll
      for (int i = 0; i < RT; ++i) {
        // y0 < ny: one subtraction wraps, unless the plane is shorter than
        // a thread's rows.
        int y = y0 + i;
        y = y < ny ? y : (ny >= RT ? y - ny : y % ny);
        m[c][i] = (ok && (FULL || i < n))
                      ? plane[static_cast<size_t>(y) * nx + x]
                      : 0u;
      }
    }
  }

  const bool exchange = g < k;
  // A strip of one pushes into its own ghosts: a block barrier orders that.
  const bool ring = S > 1;
  if (exchange && ring) cluster_arrive_relaxed();

  const Place me{P, p, nq, q, lane, tau, tcols, col0, L, n, owner};
  if (P > 1) {
    publish<RT, CT, FULL>(me, m, vert, edge, 0, false, 0);
    __syncthreads();
  }

  const unsigned full = 0xffffffffu;
  // Steps since the last warp and strip refresh, and their buffers.
  int since_w = 0, since_g = 0, eb = 0, fb = 0;
  // The tail mode's last step runs apart, after the loop.
  for (int s = 1; s <= (TAIL ? k - 1 : k); ++s) {
    uint32_t above[CT], below[CT];
    if (P == 1) {
#pragma unroll
      for (int c = 0; c < CT; ++c) {
        above[c] = last_of<RT, FULL>(m[c], n);
        below[c] = m[c][0];
      }
    } else {
      const int rb_ = (s - 1) & 1;
#pragma unroll
      for (int c = 0; c < CT; ++c) {
        const int col = in_row ? col0 + c : 0;
        above[c] = vert[(rb_ * P + pa) * tcols + col].y;
        below[c] = vert[(rb_ * P + pb) * tcols + col].x;
      }
    }
    // One step, word row by word row: each column's 3-word sum (s0, s1)
    // goes to its side columns, in the thread or by shuffle; the centre's
    // sum without itself is (x, y).
    uint32_t prev[CT];
#pragma unroll
    for (int c = 0; c < CT; ++c) prev[c] = above[c];
#pragma unroll
    for (int i = 0; i < RT; ++i) {
      uint32_t cur[CT], x[CT], y[CT], s0[CT], s1[CT];
#pragma unroll
      for (int c = 0; c < CT; ++c) {
        cur[c] = m[c][i];
        const uint32_t nxt =
            i + 1 >= RT ? below[c]
            : FULL      ? m[c][i + 1 < RT ? i + 1 : i]
                        : pick(i + 1 < n, m[c][i + 1 < RT ? i + 1 : i],
                               below[c]);
        x[c] = prev[c] ^ nxt;
        y[c] = prev[c] & nxt;
        s0[c] = x[c] ^ cur[c];
        s1[c] = y[c] | (x[c] & cur[c]);
      }
      const uint32_t l0 = __shfl_up_sync(full, s0[CT - 1], 1);
      const uint32_t l1 = __shfl_up_sync(full, s1[CT - 1], 1);
      const uint32_t r0_ = __shfl_down_sync(full, s0[0], 1);
      const uint32_t r1_ = __shfl_down_sync(full, s1[0], 1);
#pragma unroll
      for (int c = 0; c < CT; ++c) {
        m[c][i] = bitlife::count_rule(
            c == 0 ? l0 : s0[c > 0 ? c - 1 : 0],
            c == 0 ? l1 : s1[c > 0 ? c - 1 : 0],
            c == CT - 1 ? r0_ : s0[c < CT - 1 ? c + 1 : c],
            c == CT - 1 ? r1_ : s1[c < CT - 1 ? c + 1 : c], x[c], y[c],
            cur[c]);
        prev[c] = cur[c];
      }
    }
    const int vb = s & 1;
    const bool warp_refresh = nq > 1 && ++since_w == wper && s < k;
    if (warp_refresh) {
      since_w = 0;
      eb ^= 1;
    }
    if (exchange && ++since_g == g && s < k) {
      // Refresh the strip's ghosts from the neighbouring strips of the ring.
      if (ring && s == g) cluster_wait();  // pairs with the relaxed arrive
      since_g = 0;
      fb ^= 1;
      if (owner) {
        cg::cluster_group cluster = cg::this_cluster();
        const unsigned left_rank =
            static_cast<unsigned>(rank == 0 ? S - 1 : rank - 1);
        const unsigned right_rank =
            static_cast<unsigned>(rank == S - 1 ? 0 : rank + 1);
#pragma unroll
        for (int c = 0; c < CT; ++c) {
          const int col = col0 + c;
          if (col >= g && col < 2 * g) {
            uint32_t* dst =
                ghost + (((fb * 2 + 1) * g + col - g) * P + p) * RT;
            copy_words(ring ? cluster.map_shared_rank(dst, left_rank) : dst,
                       m[c]);
          }
          if (col >= L - 2 * g && col < L - g) {
            uint32_t* dst =
                ghost + (((fb * 2) * g + col - (L - 2 * g)) * P + p) * RT;
            copy_words(ring ? cluster.map_shared_rank(dst, right_rank) : dst,
                       m[c]);
          }
        }
      }
      if (ring) {
        __syncwarp();
        cluster_arrive();
        cluster_wait();
      } else {
        __syncthreads();
      }
      if (owner) {
#pragma unroll
        for (int c = 0; c < CT; ++c) {
          const int col = col0 + c;
          if (col < g)
            load_words(m[c], ghost + (((fb * 2) * g + col) * P + p) * RT);
          else if (col >= L - g && col < L)
            load_words(m[c], ghost + (((fb * 2 + 1) * g + col - (L - g)) *
                                      P + p) * RT);
        }
      }
    }
    publish<RT, CT, FULL>(me, m, vert, edge, vb, warp_refresh, eb);
    if (P > 1 || warp_refresh) __syncthreads();
    if (warp_refresh && copy) {
      // Lanes [0, tau) copy the warp before, lanes [32 - tau, 32) the warp
      // after.
      const uint32_t* src =
          lane < tau
              ? edge + ((((eb * 2 + 1) * P + p) * nq + q - 1) * tau + lane) *
                           CT * RT
              : edge + ((((eb * 2) * P + p) * nq + q + 1) * tau + lane -
                        (32 - tau)) * CT * RT;
#pragma unroll
      for (int c = 0; c < CT; ++c) load_words(m[c], src + c * RT);
    }
  }

  if constexpr (TAIL) {
    // The last step (s = k): the words this thread writes back (wb: bit
    // c * RT + i for word i of column c) stored as they are computed, and
    // their old ^ new ORed into the change word: a warp's OR, the warps'
    // through shared memory, one atomicOr a block.
    static_assert(CT * RT <= 32, "a thread's words in one mask word");
    uint32_t wb = 0;
    if (owner) {
#pragma unroll
      for (int c = 0; c < CT; ++c) {
        const int col = col0 + c;
        if (col < g || col >= g + w) continue;
#pragma unroll
        for (int i = 0; i < RT; ++i) {
          const int r = r0 + i - a.halo;
          if ((FULL || i < n) && r >= 0 && r < rb) wb |= 1u << (c * RT + i);
        }
      }
    }
    uint32_t above[CT], below[CT];
    if (P == 1) {
#pragma unroll
      for (int c = 0; c < CT; ++c) {
        above[c] = last_of<RT, FULL>(m[c], n);
        below[c] = m[c][0];
      }
    } else {
      const int rb_ = (k - 1) & 1;
#pragma unroll
      for (int c = 0; c < CT; ++c) {
        const int col = in_row ? col0 + c : 0;
        above[c] = vert[(rb_ * P + pa) * tcols + col].y;
        below[c] = vert[(rb_ * P + pb) * tcols + col].x;
      }
    }
    const size_t base = static_cast<size_t>(blockIdx.y) * ny * nx;
    uint32_t diff = tail_step<RT, CT, FULL>(
        m, above, below, n, wb, a.out + base, a.orig + base,
        a.mask[blockIdx.y], b0 + r0 - a.halo, c0 - g + col0, nx);
    __shared__ uint32_t warp_or[kMaxThreads / 32];
    diff = __reduce_or_sync(full, diff);
    if (lane == 0) warp_or[threadIdx.x >> 5] = diff;
    __syncthreads();
    if (threadIdx.x == 0) {
      uint32_t v = 0;
      for (int j = 0; j < static_cast<int>(blockDim.x >> 5); ++j)
        v |= warp_or[j];
      if (v) atomicOr(a.change + blockIdx.y, v);
    }
    return;
  }

  // The next round may begin launching; it waits above for these stores.
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  // The band's own rows of the strip's own columns.
  if (owner) {
    uint32_t* plane = a.out + static_cast<size_t>(blockIdx.y) * ny * nx;
#pragma unroll
    for (int c = 0; c < CT; ++c) {
      const int col = col0 + c;
      if (col < g || col >= g + w) continue;
      const int xg = c0 + col - g;
#pragma unroll
      for (int i = 0; i < RT; ++i) {
        const int r = r0 + i - a.halo;
        if ((FULL || i < n) && r >= 0 && r < rb)
          plane[static_cast<size_t>(b0 + r) * nx + xg] = m[c][i];
      }
    }
  }
}

using KernelFn = void (*)(const Args);

template <int RT, int CT, bool TAIL>
KernelFn form(bool full) {
  if (full) return &bitlife_bitsliced_kernel<RT, CT, true, TAIL>;
  if constexpr (CT <= 2)
    return &bitlife_bitsliced_kernel<RT, CT, false, TAIL>;
  return nullptr;
}

// The (RT, CT) pairs compiled (ops/bitlife.py:SLICED_KERNELS): every
// segment full (FULL, the banded windows) for all, a ragged form (the
// unbanded window of ny rows) for CT <= 2; each plain and in the tail mode.
KernelFn kernel_for(int rt, int ct, bool full, bool tail) {
#define SLICED_CASE(RT, CT)                                   \
  if (rt == RT && ct == CT)                                   \
    return tail ? form<RT, CT, true>(full) : form<RT, CT, false>(full);
  SLICED_CASE(2, 1) SLICED_CASE(4, 1) SLICED_CASE(6, 1) SLICED_CASE(8, 1)
  SLICED_CASE(10, 1) SLICED_CASE(12, 1) SLICED_CASE(16, 1)
  SLICED_CASE(2, 2) SLICED_CASE(4, 2) SLICED_CASE(6, 2) SLICED_CASE(8, 2)
  SLICED_CASE(10, 2) SLICED_CASE(12, 2) SLICED_CASE(16, 2)
  SLICED_CASE(2, 4) SLICED_CASE(4, 4) SLICED_CASE(6, 4)
#undef SLICED_CASE
  return nullptr;
}

int check_stack(int npl, int ny, int nx, int steps) {
  if (npl < 1 || ny < 1 || nx < 1 || steps < 0) return kErrShape;
  return 0;
}

// Checks the geometry against the (ny, nx) plane and fills `lay`; returns
// 0 or kErrGeometry / kErrShared.
int layout(int ny, int nx, int bands, int halo, int strips, int cluster,
           int g, int rt, int ct, int tau, Layout* lay) {
  *lay = Layout{};
  if (bands < 1 || bands > ny || halo < 0 || (halo == 0 && bands != 1) ||
      strips < 1 || strips > nx || strips > kMaxCluster || g < 1 ||
      tau < 1 || tau > 15 || rt < 1 || ct < 1)
    return kErrGeometry;
  // With a halo every segment is full: the window's rows are P * rt.
  const int rows = halo ? (ny + bands - 1) / bands + 2 * halo : ny;
  const int P = (rows + rt - 1) / rt;
  const int R = halo ? P * rt : ny;
  const bool full = R == P * rt;
  if (kernel_for(rt, ct, full, false) == nullptr) return kErrGeometry;
  // Ghosts refreshed through the ring (some launch steps past g), or ghost
  // zones read once (every launch steps at most halo <= g).
  const bool exchange = halo == 0 || g < halo;
  if (exchange ? (cluster != strips || g > nx / strips) : cluster != 1)
    return kErrGeometry;
  const int lmax = (nx + strips - 1) / strips + 2 * g;
  const int units = (lmax + ct - 1) / ct;
  const int nq = units <= 32 ? 1 : (units + 31 - 2 * tau) / (32 - 2 * tau);
  if (nq > 1 && exchange && g % (tau * ct)) return kErrGeometry;
  const int threads = P * 32 * nq;
  if (threads > kMaxThreads) return kErrGeometry;
  const int tcols = 32 * nq * ct;
  const int vert = P > 1 ? 2 * P * tcols * 2 : 0;
  const int edge = nq > 1 ? 2 * 2 * P * nq * tau * ct * rt : 0;
  const int ghost = exchange ? 2 * 2 * g * P * rt : 0;
  lay->R = R;
  lay->P = P;
  lay->nq = nq;
  lay->threads = threads;
  lay->full = full;
  lay->off_edge = vert;
  lay->off_ghost = vert + edge;
  lay->smem = static_cast<size_t>(vert + edge + ghost) * sizeof(uint32_t);
  if (lay->smem > static_cast<size_t>(kMaxSharedBytes)) return kErrShared;
  return 0;
}

// Sets the kernel's attributes and fills the launch configuration: grid
// (strips x bands, planes), clusters of `cluster` blocks along x.
int configure(const void* fn, const Layout& lay, int npl, int bands,
              int strips, int cluster, cudaStream_t stream,
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
  cfg->gridDim = dim3(static_cast<unsigned>(strips * bands),
                      static_cast<unsigned>(npl));
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
// would otherwise cost every call of the entry).
int max_active_clusters(const void* fn, const cudaLaunchConfig_t& cfg,
                        int cluster, int* clusters) {
  struct Entry {
    const void* fn;
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
  cudaError_t e = cudaOccupancyMaxActiveClusters(clusters, fn, &cfg);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (used < 256)
    cache[used++] = Entry{fn, cfg.blockDim.x, cfg.dynamicSmemBytes, cluster,
                          *clusters};
  return 0;
}

// Checks the stack and the geometry, configures the launch of the plain or
// the tail-mode kernel and asks the card how many clusters of it it can
// place at once; returns 0 or an error code.
int prepare(int npl, int ny, int nx, int steps, int bands, int halo,
            int strips, int cluster, int g, int rt, int ct, int tau,
            bool tail, cudaStream_t stream, Layout* lay, KernelFn* fn,
            cudaLaunchConfig_t* cfg, cudaLaunchAttribute* attr,
            int* clusters) {
  int rc = check_stack(npl, ny, nx, steps);
  if (rc) return rc;
  rc = layout(ny, nx, bands, halo, strips, cluster, g, rt, ct, tau, lay);
  if (rc) return rc;
  if (tail && lay->smem + kTailSharedBytes >
                  static_cast<size_t>(kMaxSharedBytes))
    return kErrShared;
  *fn = kernel_for(rt, ct, lay->full, tail);
  rc = configure(reinterpret_cast<const void*>(*fn), *lay, npl, bands,
                 strips, cluster, stream, cfg, attr);
  if (rc) return rc;
  return max_active_clusters(reinterpret_cast<const void*>(*fn), *cfg,
                             cluster, clusters);
}

// Issues the rounds of a call of `steps` steps from a.in on the stream of
// `cfg`, ping-ponging between `out` and `scratch` so that the last writes
// `out`, each a programmatic dependent launch (griddepcontrol in the
// kernel orders their memory); the last round launches `last`, the others
// `fn`. Counts in `*launched` the launches issued without error.
int run_rounds(Args a, KernelFn fn, KernelFn last, cudaLaunchConfig_t cfg,
               const cudaLaunchAttribute& cluster_attr, void* out,
               void* scratch, int steps, int* launched) {
  const int kmax = a.halo ? a.halo : steps;
  const int rounds = (steps + kmax - 1) / kmax;
  uint32_t* bufs[2] = {static_cast<uint32_t*>(out),
                       static_cast<uint32_t*>(scratch)};
  cudaLaunchAttribute attrs[2] = {cluster_attr, {}};
  attrs[1].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attrs[1].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attrs;
  cfg.numAttrs = 2;
  int rem = steps;
  for (int i = 0; i < rounds; ++i) {
    a.out = bufs[(rounds - 1 - i) & 1];  // the last round writes out
    a.k = rem < kmax ? rem : kmax;
    cudaError_t e = cudaLaunchKernelEx(&cfg, i == rounds - 1 ? last : fn, a);
    if (e == cudaSuccess) e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
    ++*launched;
    a.in = a.out;
    rem -= a.k;
  }
  return 0;
}

}  // namespace

// Advance the (npl, ny, nx) plane stack `in` by `steps` steps into `out` on
// `stream`, each plane over `bands` row bands with `halo` rows a side, each
// band over `strips` blocks in clusters of `cluster` with `g` ghost columns
// a side, `rt` rows and `ct` columns a thread and `tau` copied lanes a warp
// side; `scratch` is a second buffer of the same size. Runs ceil(steps /
// halo) launches (one when halo == 0) and stores in `*launched` the number
// issued without error. Returns 0, kErrShape (an extent < 1 or steps < 0),
// kErrGeometry (an illegal geometry), kErrShared (its shared memory does not
// fit a block), kErrCluster (the card cannot place one cluster of it), or
// the CUDA error code of an attribute call, the occupancy query or a
// launch.
extern "C" int bitlife_bitsliced(const void* in, void* out, void* scratch,
                                 int npl, int ny, int nx, int bands,
                                 int halo, int strips, int cluster, int g,
                                 int rt, int ct, int tau, int steps,
                                 void* stream, int* launched) {
  *launched = 0;
  Layout lay;
  KernelFn fn = nullptr;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  int clusters = 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  int rc = prepare(npl, ny, nx, steps, bands, halo, strips, cluster, g, rt,
                   ct, tau, false, s, &lay, &fn, &cfg, &attr, &clusters);
  if (rc) return rc;
  if (clusters < 1) return kErrCluster;
  if (steps == 0) return 0;
  const Args a{static_cast<const uint32_t*>(in), nullptr, ny, nx, 0, bands,
               halo, lay.R, strips, g, tau, lay.P, lay.nq, lay.off_edge,
               lay.off_ghost, nullptr, nullptr, nullptr};
  return run_rounds(a, fn, fn, cfg, attr, out, scratch, steps, launched);
}

// A resident-session pool dispatch (JAX mpi_and_open_mp_tpu/serve/pool.py:
// _pool_step_jit): `steps` steps of the (npl, ny, nx) slab `in` as
// bitlife_bitsliced runs them, with the same arguments and launches, the
// last launch in the tail mode: `out` gets (new & mask[p]) | (in & ~mask[p])
// for each plane p, and change[p] (zeroed here on the stream first) the OR
// over plane p of the last step's old ^ new. `in` is never written;
// `mask` and `change` hold npl words. Returns what bitlife_bitsliced
// returns, and kErrSteps (steps < 1) or kErrAlias (`out` or `scratch` is
// `in`) before anything runs, or the CUDA error code of the memset.
extern "C" int bitlife_bitsliced_pool(const void* in, void* out,
                                      void* scratch, const void* mask,
                                      void* change, int npl, int ny, int nx,
                                      int bands, int halo, int strips,
                                      int cluster, int g, int rt, int ct,
                                      int tau, int steps, void* stream,
                                      int* launched) {
  *launched = 0;
  if (steps < 1) return kErrSteps;
  if (out == in || scratch == in) return kErrAlias;
  Layout lay;
  KernelFn fn = nullptr, last = nullptr;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  int clusters = 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  int rc = prepare(npl, ny, nx, steps, bands, halo, strips, cluster, g, rt,
                   ct, tau, true, s, &lay, &last, &cfg, &attr, &clusters);
  if (rc) return rc;
  if (clusters < 1) return kErrCluster;
  if (halo && steps > halo) {  // rounds before the last: the plain form
    rc = prepare(npl, ny, nx, steps, bands, halo, strips, cluster, g, rt, ct,
                 tau, false, s, &lay, &fn, &cfg, &attr, &clusters);
    if (rc) return rc;
    if (clusters < 1) return kErrCluster;
  }
  cudaError_t e = cudaMemsetAsync(change, 0, sizeof(uint32_t) * npl, s);
  if (e != cudaSuccess) return static_cast<int>(e);
  const Args a{static_cast<const uint32_t*>(in), nullptr, ny, nx, 0, bands,
               halo, lay.R, strips, g, tau, lay.P, lay.nq, lay.off_edge,
               lay.off_ghost, static_cast<const uint32_t*>(in),
               static_cast<const uint32_t*>(mask),
               static_cast<uint32_t*>(change)};
  return run_rounds(a, fn, last, cfg, attr, out, scratch, steps, launched);
}

// What the CUDA runtime reports for the kernel and launch that
// bitlife_bitsliced would make with these arguments: out[0] registers a
// thread, out[1] local (spilled) bytes a thread, out[2] static and out[3]
// dynamic shared bytes a block, out[4] the clusters the card can hold at
// once (cudaOccupancyMaxActiveClusters), out[5] threads a block. Returns
// what bitlife_bitsliced would return before its occupancy check.
extern "C" int bitlife_bitsliced_attributes(int npl, int ny, int nx,
                                            int bands, int halo, int strips,
                                            int cluster, int g, int rt,
                                            int ct, int tau, int* out) {
  Layout lay;
  KernelFn fn = nullptr;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  int clusters = 0;
  int rc = prepare(npl, ny, nx, 0, bands, halo, strips, cluster, g, rt, ct,
                   tau, false, nullptr, &lay, &fn, &cfg, &attr, &clusters);
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

extern "C" const char* bitlife_bitsliced_error(int code) {
  if (code == kErrShape)
    return "the plane stack has an extent < 1, or steps < 0";
  if (code == kErrShared)
    return "the geometry's shared memory (and the tail mode's word a "
           "warp) does not fit a block's 227 KB";
  if (code == kErrGeometry)
    return "illegal launch geometry: bands outside [1, ny] (or halo 0 with "
           "more than one band), strips outside [1, min(nx, 16)], (rt, ct) "
           "not compiled, ghosts refreshed through the ring (g < halo, or "
           "no halo) without a cluster of all the strips or wider than the "
           "narrowest strip or not a multiple of tau * ct over several "
           "warps, ghost zones (g >= halo) with a cluster, tau outside [1, "
           "15], or more than 512 threads a block";
  if (code == kErrCluster)
    return "the card cannot place one cluster of this geometry "
           "(cudaOccupancyMaxActiveClusters returned 0)";
  if (code == kErrSteps)
    return "a pool dispatch of fewer than 1 step";
  if (code == kErrAlias)
    return "a pool dispatch whose out or scratch buffer is its input";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
