// stencil_padded: one step of a registered stencil rule over halo-padded
// blocks, (L, H, W) -> (L, H - 2r, W - 2r), the leading axis a stack of
// boards or the channels of one board.
//
// Replaces the TPU kernel mpi_and_open_mp_tpu/ops/pallas_life.py:
// stencil_step_padded_pallas.kernel, whose body is
// stencils/engine.py:step_padded over the whole block resident in VMEM
// (blocks past 4 MB fall back to jnp there), and through rule 0 (Life) the
// same file's _padded_step_kernel. Here the board is tiled over thread
// blocks, so any extent runs. grid = (x tiles, y tiles, groups), a group
// being one board (C channel planes, C = 2 for gray_scott, else 1).
//
// Each of a block's 256 threads computes a strip of V cells side by side in
// one row (V = 8 at r = 1, 16 at other radii, 4 for two channels), so a
// block owns 32 rows x 8 V outputs. The taps are blocked in registers: for
// each tap row, in order, a thread loads the strip's row segment from
// shared memory with 16-byte loads and applies the row's taps, in dx order,
// to all V cells, so a segment is read once per strip, not once per tap
// and cell. Each rule has a kernel of its own at its registered radius,
// with the tap row fixed at compile time (R = 1: life, heat, gray_scott,
// wireworld; R = 8: lenia): the whole segment (V + 2R cells) and the row's
// 2R + 1 weights go into registers and the row is one chunk. Any other
// radius runs the rule's generic kernel (R = 0), whose rows go in chunks of
// 8 taps over a segment that moves 8 cells at a time: ten kernels in all. A chunk whose weights are all neither 0 nor 1 (every row of
// lenia's but the centre's) runs with no test per tap; others test each
// weight. A warp holds 4 strip columns x 8 rows and a staged row is 16 bytes
// past a multiple of 128, so the 8 lanes that share a 16-byte load phase
// hit 8 distinct bank groups.
//
// The block stages its tile and the r-wide halo, every channel, in shared
// memory in the cells' own type. float32 rows (4-byte aligned) go by
// cp.async in the widest pieces (16, 8 or 4 bytes) that the tile's first
// cell and the row and plane strides allow, all in flight at once. uint8
// rows (life and wireworld, whose raw state stays there: wireworld's heads
// are taken as it is read) start at any byte, so each 16-byte piece is two
// aligned 16-byte loads shifted into place in registers; at r = 1 a wave
// of blocks steps several boards each, each thread holding its piece of
// the next board's tile in registers while this one is computed and
// storing it into a second buffer after. The offset table
// (dy, dx, float bits of w) comes in at run time in the row-major order of
// stencils/engine.py:offsets and becomes a dense grid of weights (0 where
// there is no tap) beside the tile, written while the first staging is in
// flight, so any make_lenia(r) runs without a rebuild, up to r = 61 (tile,
// grid and chunk kinds in one block's 227 KB; ops/native_stencil.py:layout
// mirrors Layout below). Each kernel's launch bounds cap its registers
// below where it would spill.
//
// The arithmetic is the plain version's, bit for bit: each cell's aggregate
// sums the taps in offsets order, a weight other than 1 multiplied first
// (__fmul_rn), then added (__fadd_rn); a zero weight is never applied; the
// sum starts at -0.0, which adds to any first term exactly. Nothing is
// contracted into an FMA. The integer rules load uint8 and compute in int32,
// as the TPU kernel's int32 cast does. One device function per rule: life,
// heat, gray_scott, wireworld and lenia, each rounding every operation on
// its own in the order of the rule bodies in stencils/spec.py; expf is the
// accurate one (no --use_fast_math). A thread writes its V outputs with the
// widest stores their address allows.
//
// Bound on the H100 (chip_smoke.py:stencil_bound_ms): bytes for heat and
// gray_scott, INT32 operations for life and wireworld, FP32 operations for
// lenia. No FMA may fuse lenia's multiply and add, so its FP32 issue bound
// counts each as one instruction at 132 x 128 lanes x 1.98 GHz: twice the
// data sheet's figure (chip_smoke.py phase 9 prints both). Left out: TMA,
// clusters, a persistent grid, and the torus halo read modulo the board
// inside the kernel (engine.torus_pad gathers it first).
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

namespace {

constexpr int kThreadsX = 8;   // strips across a tile row
constexpr int kThreadsY = 32;  // tile rows, one strip per thread each
constexpr int kThreads = kThreadsX * kThreadsY;

// Rule ids; ops/native_stencil.py:RULES holds the same numbers.
enum Rule { kLife = 0, kHeat = 1, kGrayScott = 2, kWireworld = 3, kLenia = 4 };

// The radius of the rule's registered spec (stencils/spec.py), whose
// kernel has its taps and segments fixed at compile time: 8 for lenia, 1
// for the others.
__host__ __device__ constexpr int registered_radius(int rule) {
  return rule == kLenia ? 8 : 1;
}

// The fixed radius of the kernel that runs `rule` at radius r: r at the
// rule's registered radius, else 0 (the generic kernel).
__host__ __device__ constexpr int fixed_radius(int rule, int r) {
  return r == registered_radius(rule) ? r : 0;
}

__host__ __device__ constexpr int esize(int rule) {
  return rule == kLife || rule == kWireworld ? 1 : 4;
}

__host__ __device__ constexpr int channels(int rule) {
  return rule == kGrayScott ? 2 : 1;
}

// Cells of a thread's strip: 4 for two channels (two segments and two
// sums in registers, and twice the blocks on one board), 8 at r = 1, else
// 16 (fewer segment loads per tap where the taps are many).
__host__ __device__ constexpr int strip_cells(int fixed, int channels) {
  return channels > 1 ? 4 : fixed == 1 ? 8 : 16;
}

// What a chunk of T float weights asks for: nothing (all 0), a multiply
// and an add per tap (none 0 or 1), or a test per tap.
enum Kind { kSkip = 0, kMul = 1, kMixed = 2 };

// The constants of stencils/spec.py, rounded from double to float as a
// float32 tensor times a Python float rounds them.
constexpr float kHeatAlpha = static_cast<float>(0.1);
constexpr float kGsDu = static_cast<float>(0.16);
constexpr float kGsDv = static_cast<float>(0.08);
constexpr float kGsF = static_cast<float>(0.04);
constexpr float kGsFk = static_cast<float>(0.04 + 0.06);
constexpr float kGsDt = static_cast<float>(1.0);
constexpr float kLeniaMu = static_cast<float>(0.35);
constexpr float kLeniaTwoSigma2 = static_cast<float>(2.0 * 0.25 * 0.25);
constexpr float kLeniaDt = static_cast<float>(0.1);

__device__ __forceinline__ uint8_t life_rule(int c, int agg) {
  return static_cast<uint8_t>((agg == 3) | ((agg == 2) & (c == 1)));
}

__device__ __forceinline__ uint8_t wireworld_rule(int c, int agg) {
  const int excite = (agg == 1) | (agg == 2);
  return static_cast<uint8_t>((c == 1) * 2 + (c == 2) * 3 +
                              (c == 3) * (3 - 2 * excite));
}

__device__ __forceinline__ float heat_rule(float c, float agg) {
  // c + alpha * (agg - 4 c)
  return __fadd_rn(c, __fmul_rn(__fsub_rn(agg, __fmul_rn(c, 4.0f)),
                                kHeatAlpha));
}

__device__ __forceinline__ void gray_scott_rule(float u, float v, float au,
                                                float av, float* un,
                                                float* vn) {
  const float lu = __fsub_rn(au, __fmul_rn(u, 4.0f));
  const float lv = __fsub_rn(av, __fmul_rn(v, 4.0f));
  const float uvv = __fmul_rn(__fmul_rn(u, v), v);
  // u + (DU*lu - uvv + F*(1 - u)) * DT
  const float du = __fadd_rn(__fsub_rn(__fmul_rn(lu, kGsDu), uvv),
                             __fmul_rn(__fsub_rn(1.0f, u), kGsF));
  *un = __fadd_rn(u, __fmul_rn(du, kGsDt));
  // v + (DV*lv + uvv - (F + K)*v) * DT
  const float dv = __fsub_rn(__fadd_rn(__fmul_rn(lv, kGsDv), uvv),
                             __fmul_rn(v, kGsFk));
  *vn = __fadd_rn(v, __fmul_rn(dv, kGsDt));
}

__device__ __forceinline__ float lenia_rule(float c, float agg) {
  const float d = __fsub_rn(agg, kLeniaMu);
  const float q = __fdiv_rn(-__fmul_rn(d, d), kLeniaTwoSigma2);
  const float g = __fsub_rn(__fmul_rn(expf(q), 2.0f), 1.0f);
  const float o = __fadd_rn(c, __fmul_rn(g, kLeniaDt));
  // clip to [0, 1]; a NaN stays NaN, as torch.clip and np.clip keep it.
  return o < 0.0f ? 0.0f : (o > 1.0f ? 1.0f : o);
}

__host__ __device__ constexpr int round_up(int x, int m) {
  return (x + m - 1) / m * m;
}

// A block's shared memory for `rule` at radius r: C planes (the rule's
// channels) of (kThreadsY + 2r) rows of row_bytes (the staged
// cells plus room for the last chunk's loads, padded to 16 past a multiple
// of 128 so that eight rows of one strip column fall in eight distinct
// 16-byte bank groups), then the dense weight grid ((2r + 1) rows of wp
// 4-byte weights), then one 4-byte Kind per chunk. Cells are the rule's
// own type (esize bytes).
struct Layout {
  int chunk, strip, tile_w, wp, row_bytes, tile_bytes, buffers,
      weight_bytes, kind_bytes;
  __host__ __device__ int total() const {
    return buffers * tile_bytes + weight_bytes + kind_bytes;
  }
};

__host__ __device__ inline Layout layout(int rule, int r) {
  Layout l;
  const int fixed = fixed_radius(rule, r);
  l.chunk = fixed ? 2 * fixed + 1 : 8;
  l.strip = strip_cells(fixed, channels(rule));
  l.tile_w = l.strip * kThreadsX;
  l.wp = round_up(2 * r + 1, l.chunk);
  const int row = round_up((l.tile_w + l.wp) * esize(rule), 16);
  l.row_bytes = row + (16 - row % 128 + 128) % 128;
  l.tile_bytes = channels(rule) * (kThreadsY + 2 * r) * l.row_bytes;
  // uint8 at r = 1 stages the next board while it computes this one.
  l.buffers = fixed == 1 && esize(rule) == 1 ? 2 : 1;
  l.weight_bytes = round_up((2 * r + 1) * l.wp * 4, 16);
  l.kind_bytes = round_up((2 * r + 1) * (l.wp / l.chunk) * 4, 16);
  return l;
}

// Bytes [16m, 16m + 16) of the row of `nbytes` bytes at `a` (any
// address), as two aligned 16-byte loads (the second only where it still
// holds bytes of the row) and the shift `s` that store_piece undoes. Bytes
// past the row's end are whatever memory follows it in the same aligned 16
// bytes, or 0; only outputs past the interior read them.
struct Piece {
  uint4 lo, hi;
  int s;
};

__device__ __forceinline__ Piece load_piece(const unsigned char* a,
                                            int nbytes, int m) {
  Piece p;
  p.s = static_cast<int>(reinterpret_cast<uintptr_t>(a) & 15);
  const uint4* base = reinterpret_cast<const uint4*>(a - p.s) + m;
  p.lo = __ldg(base);
  p.hi = make_uint4(0, 0, 0, 0);
  if (16 * (m + 1) < nbytes + p.s) p.hi = __ldg(base + 1);
  return p;
}

// The piece's 16 bytes, shifted into place, at `dst` (16-byte aligned).
__device__ __forceinline__ void store_piece(const Piece& p,
                                            unsigned char* dst) {
  const uint32_t x[8] = {p.lo.x, p.lo.y, p.lo.z, p.lo.w,
                         p.hi.x, p.hi.y, p.hi.z, p.hi.w};
  const int sw = p.s >> 2;
  const int sb = (p.s & 3) * 8;
  uint32_t y[5];
#pragma unroll
  for (int j = 0; j < 5; ++j) {
    y[j] = sw == 0 ? x[j] : sw == 1 ? x[j + 1] : sw == 2 ? x[j + 2]
                                                          : x[j + 3];
  }
  uint4 out;
  out.x = __funnelshift_r(y[0], y[1], sb);
  out.y = __funnelshift_r(y[1], y[2], sb);
  out.z = __funnelshift_r(y[2], y[3], sb);
  out.w = __funnelshift_r(y[3], y[4], sb);
  *reinterpret_cast<uint4*>(dst) = out;
}

// The C planes' `rows` staged float rows of `nbytes` bytes, from
// (y0, x0) of the group at `gin` (row stride W, plane stride plane_in)
// into the tile, in cp.async pieces of WIDTH bytes (the source aligned to
// them), 2^lg threads a row; the last piece of a row may run past its end
// within the same aligned WIDTH bytes.
template <int WIDTH, int C>
__device__ __forceinline__ void stage_async(const float* gin,
                                            unsigned char* tile, int rows,
                                            int nbytes, int W,
                                            size_t plane_in, int y0, int x0,
                                            int row_bytes, int plane_bytes) {
  const int per_row = (nbytes + WIDTH - 1) / WIDTH;
  const int lg = 32 - __clz(per_row - 1);
  const int items = (C * rows) << lg;
  for (int i = threadIdx.x; i < items; i += kThreads) {
    const int cy = i >> lg;
    const int k = i & ((1 << lg) - 1);
    if (k >= per_row) continue;
    const int c = C == 1 ? 0 : (cy >= rows);
    const int yy = cy - c * rows;
    const float* src = gin + c * plane_in +
                       static_cast<size_t>(y0 + yy) * W + x0 +
                       k * (WIDTH / 4);
    const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(
        tile + c * plane_bytes + yy * row_bytes + k * WIDTH));
    if constexpr (WIDTH == 16) {
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
                   "l"(src)
                   : "memory");
    } else {
      asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(dst),
                   "l"(src), "n"(WIDTH)
                   : "memory");
    }
  }
}

// A board's tile, C planes of `rows` rows of `nbytes` bytes from (y0, x0)
// of the board at `gin` (row stride W, plane stride plane_in), into `buf`:
// uint8 rows (which start at any byte) through registers, 2^lg lanes a row;
// float rows (which start on 4 bytes) by cp.async, in the widest pieces
// that the tile's first cell and the row and plane strides allow, waited
// for by the caller.
template <bool kInt, int C, typename E>
__device__ __forceinline__ void stage_tile(const E* gin, unsigned char* buf,
                                           int rows, int nbytes, int lg,
                                           int W, size_t plane_in, int y0,
                                           int x0, int row_bytes,
                                           int plane_bytes) {
  if constexpr (kInt) {
    const int warp = threadIdx.x >> 5;
    const int lane = threadIdx.x & 31;
    const int pieces = (nbytes + 15) / 16;
    for (int cy = warp * (32 >> lg) + (lane >> lg); cy < rows;
         cy += (kThreads / 32) * (32 >> lg)) {
      const unsigned char* row = reinterpret_cast<const unsigned char*>(
          gin + static_cast<size_t>(y0 + cy) * W + x0);
      for (int m = lane & ((1 << lg) - 1); m < pieces; m += 1 << lg)
        store_piece(load_piece(row, nbytes, m),
                    buf + cy * row_bytes + 16 * m);
    }
  } else {
    const uintptr_t strides =
        reinterpret_cast<uintptr_t>(gin + static_cast<size_t>(y0) * W + x0) |
        (4u * W) | (C > 1 ? 4u * plane_in : 0u);
    if ((strides & 15) == 0) {
      stage_async<16, C>(gin, buf, rows, nbytes, W, plane_in, y0, x0,
                         row_bytes, plane_bytes);
    } else if ((strides & 7) == 0) {
      stage_async<8, C>(gin, buf, rows, nbytes, W, plane_in, y0, x0,
                        row_bytes, plane_bytes);
    } else {
      stage_async<4, C>(gin, buf, rows, nbytes, W, plane_in, y0, x0,
                        row_bytes, plane_bytes);
    }
  }
}

// N consecutive field values of a staged row (N a multiple of 4, or of 4
// plus 2), from `p` (16-byte aligned for float cells, 8-byte for uint8),
// into v[0..N). Wireworld's field is its heads.
template <int RULE, int N, typename S>
__device__ __forceinline__ void load_cells(const unsigned char* p, S* v) {
  if constexpr (std::is_same<S, float>::value) {
#pragma unroll
    for (int k = 0; k < N / 4; ++k) {
      const float4 a = reinterpret_cast<const float4*>(p)[k];
      v[4 * k] = a.x;
      v[4 * k + 1] = a.y;
      v[4 * k + 2] = a.z;
      v[4 * k + 3] = a.w;
    }
    if constexpr (N % 4) {
      const float2 c = *reinterpret_cast<const float2*>(p + 4 * (N - 2));
      v[N - 2] = c.x;
      v[N - 1] = c.y;
    }
  } else {
    static_assert(N % 8 == 0 || N % 8 == 2, "uint8 segments: 8k or 8k + 2");
    uint32_t word[(N + 3) / 4];
#pragma unroll
    for (int k = 0; k < N / 8; ++k) {
      const uint2 a = reinterpret_cast<const uint2*>(p)[k];
      word[2 * k] = a.x;
      word[2 * k + 1] = a.y;
    }
    if constexpr (N % 8) word[N / 4] = *reinterpret_cast<const uint32_t*>(
                             p + N / 8 * 8);
#pragma unroll
    for (int i = 0; i < N; ++i) {
      const int b = static_cast<int>((word[i / 4] >> (8 * (i & 3))) & 0xff);
      v[i] = RULE == kWireworld ? (b == 1) : b;
    }
  }
}

// A strip's V outputs at `dst` (any address): wide stores when all n = V
// go and the address allows, else cell by cell.
template <int V>
__device__ __forceinline__ void store_strip(float* dst, const float* v,
                                            int n) {
  const uintptr_t at = reinterpret_cast<uintptr_t>(dst);
  if (n == V && (at & 15) == 0) {
#pragma unroll
    for (int k = 0; k < V / 4; ++k)
      reinterpret_cast<float4*>(dst)[k] =
          make_float4(v[4 * k], v[4 * k + 1], v[4 * k + 2], v[4 * k + 3]);
  } else if (n == V && (at & 7) == 0) {
#pragma unroll
    for (int k = 0; k < V / 2; ++k)
      reinterpret_cast<float2*>(dst)[k] = make_float2(v[2 * k], v[2 * k + 1]);
  } else {
    for (int i = 0; i < n; ++i) dst[i] = v[i];
  }
}

template <int V>
__device__ __forceinline__ void store_strip(uint8_t* dst, const uint8_t* v,
                                            int n) {
  const uintptr_t at = reinterpret_cast<uintptr_t>(dst);
  uint32_t word[V / 4];
#pragma unroll
  for (int k = 0; k < V / 4; ++k)
    word[k] = v[4 * k] | (v[4 * k + 1] << 8) | (v[4 * k + 2] << 16) |
              (static_cast<uint32_t>(v[4 * k + 3]) << 24);
  if (n == V && V % 8 == 0 && (at & 7) == 0) {
#pragma unroll
    for (int k = 0; k < V / 8; ++k)
      reinterpret_cast<uint2*>(dst)[k] = make_uint2(word[2 * k],
                                                    word[2 * k + 1]);
  } else if (n == V && (at & 3) == 0) {
#pragma unroll
    for (int k = 0; k < V / 4; ++k)
      reinterpret_cast<uint32_t*>(dst)[k] = word[k];
  } else {
    for (int i = 0; i < n; ++i) dst[i] = v[i];
  }
}

// acc[c][i] += the chunk's T taps (weights wv, in dx order) over the row
// segment v[c][i .. i + T), for the V cells of a strip: the integer rules
// in any order (a 0 weight adds 0), the float ones per `kind`.
template <bool kInt, int C, int V, int T, int NSEG, typename S>
__device__ __forceinline__ void apply_chunk(S (&acc)[C][V], S (&v)[C][NSEG],
                                            S (&wv)[T], int kind) {
  if constexpr (kInt) {
#pragma unroll
    for (int j = 0; j < T; ++j)
#pragma unroll
      for (int c = 0; c < C; ++c)
#pragma unroll
        for (int i = 0; i < V; ++i) acc[c][i] += wv[j] * v[c][i + j];
  } else if (kind == kMul) {
#pragma unroll
    for (int j = 0; j < T; ++j)
#pragma unroll
      for (int c = 0; c < C; ++c)
#pragma unroll
        for (int i = 0; i < V; ++i)
          acc[c][i] = __fadd_rn(acc[c][i], __fmul_rn(v[c][i + j], wv[j]));
  } else if (kind == kMixed) {
#pragma unroll
    for (int j = 0; j < T; ++j) {
      if (wv[j] == 0.0f) continue;
      if (wv[j] == 1.0f) {
#pragma unroll
        for (int c = 0; c < C; ++c)
#pragma unroll
          for (int i = 0; i < V; ++i)
            acc[c][i] = __fadd_rn(acc[c][i], v[c][i + j]);
      } else {
#pragma unroll
        for (int c = 0; c < C; ++c)
#pragma unroll
          for (int i = 0; i < V; ++i)
            acc[c][i] = __fadd_rn(acc[c][i], __fmul_rn(v[c][i + j], wv[j]));
      }
    }
  }
}

// One board's step from its staged tile: each thread's strip of V cells,
// tap row by tap row, then the rule, stored at `gout` (C planes of
// plane_out cells, rows of w) for the cells inside the interior.
template <int RULE, int R, int V, int T, int C, typename E, typename S>
__device__ __forceinline__ void step_board(
    const unsigned char* tile, const S* grid, const int* kinds,
    const Layout& lay, int plane_bytes, int taps, int nch, int r, int tx,
    int ty, int oy, int ox, int h, int w, E* gout, size_t plane_out) {
  constexpr bool kInt = std::is_same<E, uint8_t>::value;
  constexpr int kE = sizeof(E);
  // Cells a strip reads per chunk: V + 2R at a fixed radius (the whole
  // row segment), else V + 8, the next chunk's first V carried over.
  constexpr int kSeg = R ? V + 2 * R : V + T;
  S acc[C][V];
#pragma unroll
  for (int c = 0; c < C; ++c)
#pragma unroll
    for (int i = 0; i < V; ++i) acc[c][i] = kInt ? S(0) : S(-0.0f);

  const unsigned char* strip = tile + ty * lay.row_bytes + tx * V * kE;
  for (int dy = 0; dy < taps; ++dy) {
    const unsigned char* seg = strip + dy * lay.row_bytes;
    const S* wrow = grid + dy * lay.wp;
    S v[C][kSeg];
    if constexpr (R) {
      // The whole row segment and the row's weights: one chunk.
      S wv[T];
#pragma unroll
      for (int c = 0; c < C; ++c)
        load_cells<RULE, kSeg>(seg + c * plane_bytes, v[c]);
#pragma unroll
      for (int j = 0; j < T; ++j) wv[j] = wrow[j];
      apply_chunk<kInt>(acc, v, wv, kInt ? 0 : kinds[dy]);
    } else {
#pragma unroll
      for (int c = 0; c < C; ++c)
        load_cells<RULE, V>(seg + c * plane_bytes, v[c]);
      for (int q = 0; q < nch; ++q) {
        const int u = q * T;  // the chunk's first tap, dx = u - r
        S wv[T];
#pragma unroll
        for (int c = 0; c < C; ++c)
          load_cells<RULE, T>(seg + c * plane_bytes + (u + V) * kE,
                              v[c] + V);
        const int4 a = *reinterpret_cast<const int4*>(wrow + u);
        const int4 d = *reinterpret_cast<const int4*>(wrow + u + 4);
        const int bits[8] = {a.x, a.y, a.z, a.w, d.x, d.y, d.z, d.w};
#pragma unroll
        for (int j = 0; j < T; ++j) {
          if constexpr (kInt) {
            wv[j] = bits[j];
          } else {
            wv[j] = __int_as_float(bits[j]);
          }
        }
        apply_chunk<kInt>(acc, v, wv, kInt ? 0 : kinds[dy * nch + q]);
        // The segment moves T cells right.
#pragma unroll
        for (int c = 0; c < C; ++c)
#pragma unroll
          for (int i = 0; i < V; ++i) v[c][i] = v[c][i + T];
      }
    }
  }

  if (oy < h && ox < w) {
    // The centre cells, raw, at tile row ty + r, columns tx * V + i + r.
    const E* ctr = reinterpret_cast<const E*>(strip + r * lay.row_bytes) +
                   r;
    const size_t o = static_cast<size_t>(oy) * w + ox;
    const int n = min(V, w - ox);
    E res[C][V];
#pragma unroll
    for (int i = 0; i < V; ++i) {
      if constexpr (RULE == kLife) {
        res[0][i] = life_rule(ctr[i], acc[0][i]);
      } else if constexpr (RULE == kWireworld) {
        res[0][i] = wireworld_rule(ctr[i], acc[0][i]);
      } else if constexpr (RULE == kHeat) {
        res[0][i] = heat_rule(ctr[i], acc[0][i]);
      } else if constexpr (RULE == kLenia) {
        res[0][i] = lenia_rule(ctr[i], acc[0][i]);
      } else {
        const E* ctr_v = reinterpret_cast<const E*>(
            reinterpret_cast<const unsigned char*>(ctr) + plane_bytes);
        gray_scott_rule(ctr[i], ctr_v[i], acc[0][i], acc[C - 1][i],
                        &res[0][i], &res[C - 1][i]);
      }
    }
#pragma unroll
    for (int c = 0; c < C; ++c)
      store_strip<V>(gout + c * plane_out + o, res[c], n);
  }
}

// Blocks an SM should hold for each kernel, which caps its registers at
// 65536 / (256 x blocks), each cap the least that does not spill: lenia at
// radius 8 at 64 registers, heat at r = 1 at 40, life and wireworld at r = 1
// (which hold a staged piece across the compute) at 51, gray_scott at r = 1
// and the generic kernels at 80. Left to itself ptxas gives lenia's
// radius-8 kernel 124 registers, two blocks an SM, and it runs slower.
__host__ __device__ constexpr int min_blocks(int rule, int fixed) {
  return fixed == 8   ? 4
         : fixed != 1 ? 3
         : rule == kHeat ? 6
         : rule == kLife || rule == kWireworld ? 5
                                               : 3;
}

template <int RULE, int R>
__global__ void __launch_bounds__(kThreads, min_blocks(RULE, R))
stencil_padded_kernel(const void* __restrict__ in_, void* __restrict__ out_,
                      const int* __restrict__ table, int n_off, int groups,
                      int H, int W, int r) {
  constexpr bool kInt = RULE == kLife || RULE == kWireworld;
  constexpr int C = channels(RULE);
  constexpr int V = strip_cells(R, C);
  // Taps a chunk: a whole tap row at a fixed radius, else 8.
  constexpr int T = R ? 2 * R + 1 : 8;
  using E = typename std::conditional<kInt, uint8_t, float>::type;
  using S = typename std::conditional<kInt, int, float>::type;
  constexpr int kE = sizeof(E);
  const E* in = static_cast<const E*>(in_);
  E* out = static_cast<E*>(out_);

  const Layout lay = layout(RULE, r);
  const int taps = R ? T : 2 * r + 1;  // rows of taps, taps per row
  const int nch = R ? 1 : lay.wp / T;  // chunks per tap row
  const int h = H - 2 * r;
  const int w = W - 2 * r;
  const int plane_rows = kThreadsY + 2 * r;
  const int plane_bytes = plane_rows * lay.row_bytes;

  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* tile = smem;
  S* grid = reinterpret_cast<S*>(smem + lay.buffers * lay.tile_bytes);
  int* kinds = reinterpret_cast<int*>(smem + lay.buffers * lay.tile_bytes +
                                      lay.weight_bytes);

  // A warp holds 4 strip columns x 8 rows; lanes 8k .. 8k + 7 share a
  // column, so their 16-byte loads fall in distinct bank groups.
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int tx = (warp & 1) * 4 + (lane >> 3);
  const int ty = (warp >> 1) * 8 + (lane & 7);

  // The offset table becomes a dense grid of weights, 0 where there is no
  // tap: zeroed now, its taps written once the first group's staging is
  // under way (this thread's first tap is loaded now, so that its latency
  // and the staging's overlap).
  for (int k = tid; k < taps * lay.wp; k += kThreads) grid[k] = 0;
  int tap[3] = {0, 0, 0};
  if (tid < n_off) {
    tap[0] = table[3 * tid];
    tap[1] = table[3 * tid + 1];
    tap[2] = table[3 * tid + 2];
  }
  __syncthreads();

  const int y0 = blockIdx.y * kThreadsY;
  const int x0 = blockIdx.x * lay.tile_w;
  const int rows = min(plane_rows, H - y0);                  // rows staged
  const int nbytes = min(lay.tile_w + 2 * r, W - x0) * kE;   // bytes a row
  const int pieces = (nbytes + 15) / 16;
  // Lanes a staged uint8 row: the least power of two >= pieces, at most 32.
  const int lg = pieces <= 4 ? 2 : pieces <= 8 ? 3 : pieces <= 16 ? 4 : 5;
  const size_t plane_in = static_cast<size_t>(H) * W;
  const size_t plane_out = static_cast<size_t>(h) * w;
  const int oy = y0 + ty;
  const int ox = x0 + tx * V;
  // Life and wireworld at r = 1 spend as long waiting for a board's tile
  // as computing it, so a block steps several boards and stages the next
  // one, in the other of two tile buffers, while it computes this one: each
  // thread loads its piece of the next tile into registers first and stores
  // it after (a tile's 34 rows of at most 5 pieces fit 256 threads). Float
  // rows, staged by cp.async with many boards' blocks in flight, gain
  // nothing from it.
  constexpr bool kPipe = R == 1 && kInt;
  static_assert(!kPipe || (kThreadsY + 2) * ((8 * kThreadsX + 2 + 15) / 16)
                              <= kThreads,
                "one staged uint8 piece a thread at r = 1");

  // The taps into the zeroed grid and, for the float rules, each chunk's
  // kind (after a barrier, as the grid is read across threads).
  auto scatter = [&]() {
    if (tid < n_off)
      grid[(tap[0] + r) * lay.wp + tap[1] + r] =
          static_cast<S>(__int_as_float(tap[2]));
    for (int k = tid + kThreads; k < n_off; k += kThreads)
      grid[(table[3 * k] + r) * lay.wp + table[3 * k + 1] + r] =
          static_cast<S>(__int_as_float(table[3 * k + 2]));
    if constexpr (!kInt) {
      __syncthreads();
      for (int q = tid; q < taps * nch; q += kThreads) {
        const float* wq = grid + (q / nch) * lay.wp + (q % nch) * T;
        bool any = false, all_mul = true;
        for (int j = 0; j < T; ++j) {
          any |= wq[j] != 0.0f;
          all_mul &= wq[j] != 0.0f && wq[j] != 1.0f;
        }
        kinds[q] = all_mul ? kMul : (any ? kMixed : kSkip);
      }
    }
  };

  if constexpr (kPipe) {
    // The first board, then each board while the next one's pieces are in
    // flight; the two tile buffers alternate.
    stage_tile<kInt, C>(in + static_cast<size_t>(blockIdx.z) * plane_in,
                        tile, rows, nbytes, lg, W, plane_in, y0, x0,
                        lay.row_bytes, plane_bytes);
    scatter();
    __syncthreads();
    Piece held;
    int held_at = -1;
    int cur = 0;
    for (int g = blockIdx.z; g < groups; g += gridDim.z) {
      const int next = g + gridDim.z;
      if (next < groups && tid < rows * pieces) {
        const int cy = tid / pieces;
        const int m = tid - cy * pieces;
        held = load_piece(reinterpret_cast<const unsigned char*>(
                              in + static_cast<size_t>(next) * plane_in +
                              static_cast<size_t>(y0 + cy) * W + x0),
                          nbytes, m);
        held_at = cy * lay.row_bytes + 16 * m;
      }
      step_board<RULE, R, V, T, C>(
          tile + cur * lay.tile_bytes, grid, kinds, lay, plane_bytes, taps,
          nch, r, tx, ty, oy, ox, h, w, out + static_cast<size_t>(g) * plane_out,
          plane_out);
      if (next < groups) {
        cur ^= 1;
        if (held_at >= 0)
          store_piece(held, tile + cur * lay.tile_bytes + held_at);
        __syncthreads();
      }
    }
  } else {
    for (int g = blockIdx.z; g < groups; g += gridDim.z) {
      if (g != blockIdx.z) __syncthreads();  // the last board's reads are done
      stage_tile<kInt, C>(in + static_cast<size_t>(g) * C * plane_in, tile,
                          rows, nbytes, lg, W, plane_in, y0, x0,
                          lay.row_bytes, plane_bytes);
      if (g == blockIdx.z) scatter();  // while the first board is in flight
      if constexpr (!kInt) asm volatile("cp.async.wait_all;\n" ::: "memory");
      __syncthreads();
      step_board<RULE, R, V, T, C>(
          tile, grid, kinds, lay, plane_bytes, taps, nch, r, tx, ty, oy, ox,
          h, w, out + static_cast<size_t>(g) * C * plane_out, plane_out);
    }
  }
}

template <int RULE, int R>
int launch_t(const void* in, void* out, const void* table, int n_off,
             int groups, int H, int W, int r, cudaStream_t stream) {
  const int h = H - 2 * r;
  const int w = W - 2 * r;
  const Layout lay = layout(RULE, r);
  const int smem = lay.total();
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        stencil_padded_kernel<RULE, R>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const int gx = (w + lay.tile_w - 1) / lay.tile_w;
  const int gy = (h + kThreadsY - 1) / kThreadsY;
  int gz = groups < 65535 ? groups : 65535;
  if (R == 1 && esize(RULE) == 1) {
    // One wave of blocks, each stepping boards g, g + gz, ... (the next
    // staged while this one is computed).
    int dev = 0, sms = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return static_cast<int>(e);
    const int wave = sms * min_blocks(RULE, R) / (gx * gy);
    gz = wave < 1 ? 1 : (wave < gz ? wave : gz);
  }
  const dim3 grid(gx, gy, gz);
  stencil_padded_kernel<RULE, R><<<grid, kThreads, smem, stream>>>(
      in, out, static_cast<const int*>(table), n_off, groups, H, W, r);
  return static_cast<int>(cudaGetLastError());
}

template <int RULE>
int launch(const void* in, void* out, const void* table, int n_off,
           int groups, int H, int W, int r, cudaStream_t stream) {
  constexpr int kR = registered_radius(RULE);
  if (r == kR)
    return launch_t<RULE, kR>(in, out, table, n_off, groups, H, W, r,
                              stream);
  return launch_t<RULE, 0>(in, out, table, n_off, groups, H, W, r, stream);
}

template <int RULE>
int attributes(int r, int* out) {
  constexpr int kR = registered_radius(RULE);
  cudaFuncAttributes a;
  const cudaError_t e =
      r == kR ? cudaFuncGetAttributes(&a, stencil_padded_kernel<RULE, kR>)
              : cudaFuncGetAttributes(&a, stencil_padded_kernel<RULE, 0>);
  if (e != cudaSuccess) return static_cast<int>(e);
  out[0] = a.numRegs;
  out[1] = static_cast<int>(a.localSizeBytes);
  out[2] = static_cast<int>(a.sharedSizeBytes);
  out[3] = layout(RULE, r).total();
  return 0;
}

}  // namespace

// One step of rule `rule` over `groups` padded boards of (C, H, W) at `in`
// (uint8 for life and wireworld, float32 otherwise) into `out`
// (C, H - 2r, W - 2r each), on `stream`. `table` is n_off x 3 int32 on
// the device: dy, dx and the float32 bits of the weight. Returns 0 or the
// CUDA error code of the attribute call or the launch; -1 for an unknown
// rule.
extern "C" int stencil_padded(const void* in, void* out, const void* table,
                              int n_off, int groups, int H, int W, int r,
                              int rule, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (rule) {
    case kLife:
      return launch<kLife>(in, out, table, n_off, groups, H, W, r, s);
    case kHeat:
      return launch<kHeat>(in, out, table, n_off, groups, H, W, r, s);
    case kGrayScott:
      return launch<kGrayScott>(in, out, table, n_off, groups, H, W, r, s);
    case kWireworld:
      return launch<kWireworld>(in, out, table, n_off, groups, H, W, r, s);
    case kLenia:
      return launch<kLenia>(in, out, table, n_off, groups, H, W, r, s);
    default:
      return -1;
  }
}

// The CUDA runtime's attributes of the kernel that stencil_padded launches
// for `rule` at radius r, stencil_padded_kernel<rule, fixed_radius(rule,
// r)> (the rule's registered radius, else 0 for the generic kernel):
// out[4] = registers, local (spilled) bytes, static shared bytes, and the
// dynamic shared bytes a launch at radius r requests.
// Returns 0, a CUDA error code, or -1 for an unknown rule.
extern "C" int stencil_padded_attributes(int rule, int r, int* out) {
  switch (rule) {
    case kLife:
      return attributes<kLife>(r, out);
    case kHeat:
      return attributes<kHeat>(r, out);
    case kGrayScott:
      return attributes<kGrayScott>(r, out);
    case kWireworld:
      return attributes<kWireworld>(r, out);
    case kLenia:
      return attributes<kLenia>(r, out);
    default:
      return -1;
  }
}

extern "C" const char* stencil_padded_error(int code) {
  if (code == -1) return "unknown stencil rule";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
