// flash_hop_bwd: the flash backward's block gradients against a saved
// logsumexp L and D = rowsum(do·o), as two kernels:
//
//   flash_hop_dq:  dq = scale · t k,                 over the k tiles
//   flash_hop_dkv: dk = scale · tᵀ q,  dv = pᵀ do,    over the q tiles and
//                                                     the query group
//
// with p = exp(s - L) (s = q kᵀ·scale; 0 where kpos >= n, and where
// kpos > qpos under causal) and t = p∘(do vᵀ - D), for q, do (h, n, d),
// k, v (hkv, n, d) and L, D (h, n) float32; outputs float32.
//
// Replaces mpi_and_open_mp_tpu/ops/flash_hop_bwd.py:_dq_kernel and
// :_dkv_kernel (the ring backward's per-hop kernels, which accumulate into
// an output ref revisited along the TPU's sequential minor grid axis).
// Here one thread block owns each output tile and loops over the tiles it
// sums, so blocks never share an output and need no atomics: the dq block
// (128 q rows of one query head) walks the k tiles of its K/V head; the
// dk/dv block (128 k rows of one K/V head) walks, for each of the g query
// heads of that K/V head, the q tiles, which is where GQA's group sum
// happens. Under causal, tiles wholly above the diagonal are skipped, and
// the blocks with the most tiles start first. The JAX kernels take GQA K/V
// pre-expanded and L, D lane-broadcast to 128 lanes (the TPU's layout);
// these take them as they are. Their plain version is
// parallel/context.py:_flash_block_grads over chunked blocks
// (ops/flash_hop_bwd.py:hop_block_grads_plain).
//
// Bound on the H100: operations. Causal, dq does three products of
// h n^2 d / 2 multiply-adds each (s, do vᵀ, t k) and dk/dv four (s, v doᵀ,
// pᵀ do, tᵀ q): 3.3 and 4.4 TFLOP at 8 x 32768 x 128, 3.3 and 4.4 ms at
// the 989 TFLOP/s bf16 tensor-core peak, against about 0.1 ms for their
// bytes. So bf16 operands run every product on the tensor cores
// (flash_sm90.cuh): two warpgroups of 64 rows each issue wgmma m64nNk16
// bf16 -> f32, the block's own tiles (q, do for dq; k, v for dk/dv) stay
// in shared memory for the whole loop, and the streamed tiles (k, v; q, do
// with their L, D rows) arrive by 16-byte cp.async into a two-stage ring
// in the 128-byte swizzle, tile i + 1 loading while tile i is multiplied.
// s and do vᵀ (sᵀ = k qᵀ and v doᵀ for dk/dv, as FlashAttention-2 and -3
// do, so that pᵀ and tᵀ come out as rows) take both operands from shared
// memory; p and t then stay in registers, where the accumulator's layout
// is the A operand's of the second product. The JAX kernels and SDPA
// round p and t to bf16 for it; that misses the float32 fold by more than
// the 5e-4 the gradients are held to (tests/test_torch_attention.py:
// test_split_products_within_the_gate). So each is split, hi = bf16(x) and
// lo = bf16(x - hi), and the second product runs twice, hi and lo, into
// the float32 accumulator: exact to about 2^-16 of p and t, at 4 products
// for dq and 6 for dk/dv instead of 3 and 4. exp is exp2f with log2 e
// folded into scale and L. The tensor cores' float32 sums do not round to
// nearest: summed over a whole 32k column, dv drifted to most of the 5e-4
// limit. So the dk/dv block moves its partial sums into dk, dv (its own
// rows, float32 adds) every kDkvFlush steps and restarts them at 0. And
// the first row of a causal dq sees one key, so its gradient cancels
// exactly: dq_0 = scale p_00 (do_0 . v_0 - D_0) k_0, with D_0 = do_0 . o_0
// and o_0 = v_0, is nothing but the rounding of the two sums of do_0 v_0.
// On an H100 the FMA kernel's fmaf in order of d gave the float32 fold's
// row 0 bit for bit; the tensor cores' sum rounds otherwise and put it
// up to 1.4x past the 1e-6·max(|dq|) its gradients are held to at 32k
// (chip_smoke.py phase 11). So on a warpgroup's causal diagonal tile,
// where every row that sees few keys lies, dq sums dp again on the FP32
// units in order of d (diagonal_dp): one tile of a row's n / 64, 64 x 64
// x d fmaf per warpgroup.
//
// Float32 operands keep the first, FMA design (not redesigned): float32
// tiles in shared memory, every product on the FP32 units, expf.
#include "flash_common.cuh"
#include "flash_sm90.cuh"

#include <cmath>

namespace {

using namespace flash;

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_hop_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v,
                    const float* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, float* __restrict__ dq,
                    int h, int hkv, int n, int causal, float scale) {
  constexpr int kCols = D / 16;
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;
  float* dos = qs + kBlock * (D + 1);
  float* ks = dos + kBlock * (D + 1);
  float* vs = ks + kBlock * (D + 1);
  float* ts = vs + kBlock * (D + 1);

  const int tiles = (n + kBlock - 1) / kBlock;
  const int qt = tiles - 1 - static_cast<int>(blockIdx.x);  // heavy first
  const int ih = blockIdx.y;
  const int ikv = ih / (h / hkv);
  const int q0 = qt * kBlock;
  const int tx = tid_x(), ty = tid_y();
  const size_t head = static_cast<size_t>(n) * D;
  const float* kh = k + ikv * head;
  const float* vh = v + ikv * head;

  load_tile<D>(qs, q + ih * head, q0, n);
  load_tile<D>(dos, dout + ih * head, q0, n);
  float lr[kRows], dr[kRows];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int row = q0 + ty + 16 * i;
    const size_t at = static_cast<size_t>(ih) * n + row;
    lr[i] = row < n ? lse[at] : -kNeg;  // padded rows: p underflows to 0
    dr[i] = row < n ? delta[at] : 0.0f;
  }
  float acc[kRows][kCols];
#pragma unroll
  for (int i = 0; i < kRows; ++i)
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[i][c] = 0.0f;

  const int kt_end = causal ? qt + 1 : tiles;
  for (int kt = 0; kt < kt_end; ++kt) {
    const int k0 = kt * kBlock;
    __syncthreads();  // the last tile's reads of ks, ts are done
    load_tile<D>(ks, kh, k0, n);
    load_tile<D>(vs, vh, k0, n);
    __syncthreads();

    float s[kRows][kRows], dp[kRows][kRows];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int j = 0; j < kRows; ++j) s[i][j] = dp[i][j] = 0.0f;
    dot_nt<D>(qs, ks, s);
    dot_nt<D>(dos, vs, dp);
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int qpos = q0 + ty + 16 * i;
#pragma unroll
      for (int j = 0; j < kRows; ++j) {
        const int kpos = k0 + tx + 16 * j;
        const bool ok = kpos < n && (!causal || kpos <= qpos);
        const float p = ok ? expf(s[i][j] * scale - lr[i]) : 0.0f;
        ts[(ty + 16 * i) * kScoreLd + tx + 16 * j] = p * (dp[i][j] - dr[i]);
      }
    }
    __syncthreads();
    dot_nn<D>(ts, ks, acc);
  }

#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= n) continue;
    float* out = dq + ih * head + static_cast<size_t>(row) * D;
#pragma unroll
    for (int c = 0; c < kCols; ++c) out[tx + 16 * c] = scale * acc[i][c];
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_hop_dkv_kernel(const float* __restrict__ q,
                     const float* __restrict__ k,
                     const float* __restrict__ v,
                     const float* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, float* __restrict__ dk,
                     float* __restrict__ dv, int h, int hkv, int n,
                     int causal, float scale) {
  constexpr int kCols = D / 16;
  extern __shared__ __align__(16) float smem[];
  float* ks = smem;
  float* vs = ks + kBlock * (D + 1);
  float* qs = vs + kBlock * (D + 1);
  float* dos = qs + kBlock * (D + 1);
  float* ps = dos + kBlock * (D + 1);
  float* ts = ps + kBlock * kScoreLd;
  float* ls = ts + kBlock * kScoreLd;
  float* ds = ls + kBlock;

  const int tiles = (n + kBlock - 1) / kBlock;
  const int kt = blockIdx.x;  // causal: the first k tiles carry the most
  const int ikv = blockIdx.y;
  const int g = h / hkv;
  const int k0 = kt * kBlock;
  const int tx = tid_x(), ty = tid_y();
  const size_t head = static_cast<size_t>(n) * D;

  load_tile<D>(ks, k + ikv * head, k0, n);
  load_tile<D>(vs, v + ikv * head, k0, n);
  float acc_k[kRows][kCols], acc_v[kRows][kCols];
#pragma unroll
  for (int i = 0; i < kRows; ++i)
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc_k[i][c] = acc_v[i][c] = 0.0f;

  for (int ih = ikv * g; ih < (ikv + 1) * g; ++ih) {
    for (int qt = causal ? kt : 0; qt < tiles; ++qt) {
      const int q0 = qt * kBlock;
      __syncthreads();  // the last tile's reads of qs, dos, ps, ts are done
      load_tile<D>(qs, q + ih * head, q0, n);
      load_tile<D>(dos, dout + ih * head, q0, n);
      if (threadIdx.x < kBlock) {
        const int row = q0 + threadIdx.x;
        const size_t at = static_cast<size_t>(ih) * n + row;
        ls[threadIdx.x] = row < n ? lse[at] : -kNeg;
        ds[threadIdx.x] = row < n ? delta[at] : 0.0f;
      }
      __syncthreads();

      // Transposed score tiles: rows are keys (ty + 16 i), columns
      // queries (tx + 16 j).
      float s[kRows][kRows], dp[kRows][kRows];
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int j = 0; j < kRows; ++j) s[i][j] = dp[i][j] = 0.0f;
      dot_nt<D>(ks, qs, s);
      dot_nt<D>(vs, dos, dp);
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        const int kpos = k0 + ty + 16 * i;
#pragma unroll
        for (int j = 0; j < kRows; ++j) {
          const int col = tx + 16 * j;
          const int qpos = q0 + col;
          const bool ok = qpos < n && kpos < n && (!causal || kpos <= qpos);
          const float p = ok ? expf(s[i][j] * scale - ls[col]) : 0.0f;
          ps[(ty + 16 * i) * kScoreLd + col] = p;
          ts[(ty + 16 * i) * kScoreLd + col] = p * (dp[i][j] - ds[col]);
        }
      }
      __syncthreads();
      dot_nn<D>(ps, dos, acc_v);
      dot_nn<D>(ts, qs, acc_k);
    }
  }

#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int row = k0 + ty + 16 * i;
    if (row >= n) continue;
    const size_t at = ikv * head + static_cast<size_t>(row) * D;
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      dk[at + tx + 16 * c] = scale * acc_k[i][c];
      dv[at + tx + 16 * c] = acc_v[i][c];
    }
  }
}

// ---------------------------------------------------------------- bf16:
// the tensor-core kernels.

using bf16 = __nv_bfloat16;

constexpr int kTcRows = 64;                      // rows of a warpgroup
constexpr int kTcGroups = 2;                     // warpgroups of a block
constexpr int kTcThreads = 128 * kTcGroups;
constexpr int kTcOwn = kTcRows * kTcGroups;      // rows a block owns
constexpr int kDqStream = 64;                    // k rows of a dq step
constexpr int kDkvStream = 64;                   // q rows of a dk/dv step
constexpr int kTcStages = 2;                     // the streamed tiles' ring
// A dq step's k tile is a warpgroup's height: the causal diagonal is one
// whole tile of each warpgroup.
static_assert(kDqStream == kTcRows, "dq: one diagonal tile per warpgroup");
constexpr int kDkvFlush = 64;  // dk/dv steps summed on the tensor cores
constexpr float kLog2e = 1.4426950408889634f;

// Shared memory of a block (ops/flash_hop_bwd.py:smem_bytes): 1024 bytes
// to align the tiles, the two owned tiles, and per stage the two streamed
// tiles (and for dk/dv their L and D rows).
template <int D>
constexpr size_t dq_smem() {
  return 1024 + 2 * kTcOwn * D * 2 + kTcStages * 2 * kDqStream * D * 2;
}
template <int D>
constexpr size_t dkv_smem() {
  return 1024 + 2 * kTcOwn * D * 2 +
         kTcStages * (2 * kDkvStream * D * 2 + 2 * kDkvStream * 4);
}

using sm90::align1024;
using sm90::TcThread;

// dp = do vᵀ of a warpgroup's causal diagonal tile, in the accumulator's
// layout, on the FP32 units: each entry summed in order of d from 0 by
// round-to-nearest fmaf, as dot_nt sums it in the FMA kernel and as the
// float32 fold's product sums it. `row` is the thread's first row r0 in
// the owned do tile; vs the stage's v tile.
template <int D>
__device__ __forceinline__ void diagonal_dp(float (&dp)[kDqStream / 2],
                                            const bf16* dos, int row,
                                            const bf16* vs, int c0) {
#pragma unroll
  for (int i = 0; i < kDqStream / 2; ++i) dp[i] = 0.0f;
#pragma unroll 1
  for (int cc = 0; cc < D / 8; ++cc) {  // 16-byte chunks, in order
    float a[2][8];
    sm90::read_chunk<kTcOwn>(a[0], dos, row, cc);
    sm90::read_chunk<kTcOwn>(a[1], dos, row + 8, cc);
#pragma unroll
    for (int j = 0; j < kDqStream / 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float b[8];
        sm90::read_chunk<kDqStream>(b, vs, 8 * j + c0 + e, cc);
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int x = 0; x < 8; ++x)
            dp[4 * j + 2 * i + e] =
                fmaf(a[i][x], b[x], dp[4 * j + 2 * i + e]);
      }
  }
}

template <int D>
__global__ void __launch_bounds__(kTcThreads, 1)
flash_hop_dq_tc(const bf16* __restrict__ q, const bf16* __restrict__ k,
                const bf16* __restrict__ v, const bf16* __restrict__ dout,
                const float* __restrict__ lse,
                const float* __restrict__ delta, float* __restrict__ dq,
                int h, int hkv, int n, int causal, float scale) {
  constexpr int kStage = 2 * kDqStream * D;  // elements: k tile, v tile
  extern __shared__ char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(align1024(smem_raw));
  bf16* dos = qs + kTcOwn * D;
  bf16* ring = dos + kTcOwn * D;

  const int ih = blockIdx.x;
  const int tiles = (n + kTcOwn - 1) / kTcOwn;
  const int q0 = (tiles - 1 - static_cast<int>(blockIdx.y)) * kTcOwn;
  const size_t head = static_cast<size_t>(n) * D;
  const bf16* kh = k + (ih / (h / hkv)) * head;
  const bf16* vh = v + (ih / (h / hkv)) * head;
  const TcThread th;
  const int tid = threadIdx.x;
  const int wq0 = q0 + kTcRows * th.wg;  // the warpgroup's first q row
  const int ksteps =
      ((causal ? min(q0 + kTcOwn, n) : n) + kDqStream - 1) / kDqStream;

  auto load_kv = [&](int kt) {
    bf16* st = ring + (kt % kTcStages) * kStage;
    sm90::load_tile<kDqStream, D>(st, kh, kt * kDqStream, n, tid,
                                  kTcThreads);
    sm90::load_tile<kDqStream, D>(st + kDqStream * D, vh, kt * kDqStream, n,
                                  tid, kTcThreads);
  };
  sm90::load_tile<kTcOwn, D>(qs, q + ih * head, q0, n, tid, kTcThreads);
  sm90::load_tile<kTcOwn, D>(dos, dout + ih * head, q0, n, tid, kTcThreads);
  load_kv(0);
  sm90::cp_async_commit();

  const float sl2 = scale * kLog2e;
  float l2[2], dr[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = wq0 + th.r0 + 8 * i;
    const size_t at = static_cast<size_t>(ih) * n + row;
    l2[i] = row < n ? lse[at] * kLog2e : 0.0f;
    dr[i] = row < n ? delta[at] : 0.0f;
  }
  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.0f;

  for (int kt = 0; kt < ksteps; ++kt) {
    if (kt + 1 < ksteps) load_kv(kt + 1);
    sm90::cp_async_commit();
    sm90::cp_async_wait<1>();  // tile kt (and q, do) have landed
    __syncthreads();
    const bf16* ks = ring + (kt % kTcStages) * kStage;
    const bf16* vs = ks + kDqStream * D;
    const int k0 = kt * kDqStream;
    // The warpgroup skips a tile wholly above its diagonal or past n.
    if (wq0 < n && (!causal || k0 <= wq0 + kTcRows - 1)) {
      float s[kDqStream / 2], dp[kDqStream / 2];
      sm90::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        sm90::mma_ss<kDqStream>(
            s, sm90::desc_k<kTcOwn>(qs, kTcRows * th.wg, kk),
            sm90::desc_k<kDqStream>(ks, 0, kk), kk);
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        sm90::mma_ss<kDqStream>(
            dp, sm90::desc_k<kTcOwn>(dos, kTcRows * th.wg, kk),
            sm90::desc_k<kDqStream>(vs, 0, kk), kk);
      sm90::wgmma_commit();
      sm90::wgmma_wait<0>();
      sm90::fence_regs(s);
      sm90::fence_regs(dp);
      // The causal diagonal tile sums dp again on the FP32 units, in
      // order of d (module note).
      if (causal && k0 == wq0)
        diagonal_dp<D>(dp, dos, kTcRows * th.wg + th.r0, vs, th.c0);
#pragma unroll
      for (int j = 0; j < kDqStream / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int row = wq0 + th.r0 + 8 * (e / 2);
          const int col = k0 + 8 * j + th.c0 + e % 2;
          const bool ok = col < n && (!causal || col <= row);
          const float p =
              ok ? exp2f(fmaf(s[4 * j + e], sl2, -l2[e / 2])) : 0.0f;
          dp[4 * j + e] = p * (dp[4 * j + e] - dr[e / 2]);  // t
        }
      uint32_t hi[kDqStream / 16][4], lo[kDqStream / 16][4];
      sm90::pack_a<kDqStream>(dp, hi, lo);
      sm90::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kDqStream / 16; ++kk) {
        sm90::mma_rs_t<D>(acc, hi[kk], sm90::desc_mn<kDqStream>(ks, kk), 1);
        sm90::mma_rs_t<D>(acc, lo[kk], sm90::desc_mn<kDqStream>(ks, kk), 1);
      }
      sm90::wgmma_commit();
      sm90::wgmma_wait<0>();
      sm90::fence_regs(acc);
      sm90::fence_regs(hi);
      sm90::fence_regs(lo);
    }
    __syncthreads();  // the stage is read before tile kt + 2 refills it
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = wq0 + th.r0 + 8 * i;
    if (row >= n) continue;
    float* out = dq + ih * head + static_cast<size_t>(row) * D + th.c0;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<float2*>(out + 8 * j) =
          make_float2(scale * acc[4 * j + 2 * i], scale * acc[4 * j + 2 * i + 1]);
  }
}

template <int D>
__global__ void __launch_bounds__(kTcThreads, 1)
flash_hop_dkv_tc(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, const bf16* __restrict__ dout,
                 const float* __restrict__ lse,
                 const float* __restrict__ delta, float* __restrict__ dk,
                 float* __restrict__ dv, int h, int hkv, int n, int causal,
                 float scale) {
  constexpr int kStage = 2 * kDkvStream * D;  // elements: q tile, do tile
  extern __shared__ char smem_raw[];
  bf16* ks = reinterpret_cast<bf16*>(align1024(smem_raw));
  bf16* vs = ks + kTcOwn * D;
  bf16* ring = vs + kTcOwn * D;
  float* lds = reinterpret_cast<float*>(ring + kTcStages * kStage);
  // lds: per stage, kDkvStream rows of L, then kDkvStream of D.

  const int ikv = blockIdx.x;
  const int k0 = blockIdx.y * kTcOwn;  // causal: the first k tiles carry most
  const int g = h / hkv;
  const size_t head = static_cast<size_t>(n) * D;
  const TcThread th;
  const int tid = threadIdx.x;
  const int wk0 = k0 + kTcRows * th.wg;  // the warpgroup's first k row
  const int qtiles = (n + kDkvStream - 1) / kDkvStream;
  const int qt0 = causal ? k0 / kDkvStream : 0;
  const int per_head = qtiles - qt0;
  const int steps = g * per_head;

  auto load_q = [&](int it) {
    const int ih = ikv * g + it / per_head;
    const int q0 = (qt0 + it % per_head) * kDkvStream;
    bf16* st = ring + (it % kTcStages) * kStage;
    sm90::load_tile<kDkvStream, D>(st, q + ih * head, q0, n, tid,
                                   kTcThreads);
    sm90::load_tile<kDkvStream, D>(st + kDkvStream * D, dout + ih * head, q0,
                                   n, tid, kTcThreads);
    if (tid < 2 * kDkvStream) {
      const int i = tid % kDkvStream;
      const float* from = (tid < kDkvStream ? lse : delta) +
                          static_cast<size_t>(ih) * n + q0 + i;
      sm90::cp_async4(lds + (it % kTcStages) * 2 * kDkvStream + tid,
                      q0 + i < n ? from : lse, q0 + i < n);
    }
  };
  sm90::load_tile<kTcOwn, D>(ks, k + ikv * head, k0, n, tid, kTcThreads);
  sm90::load_tile<kTcOwn, D>(vs, v + ikv * head, k0, n, tid, kTcThreads);
  load_q(0);
  sm90::cp_async_commit();

  const float sl2 = scale * kLog2e;
  float acck[D / 2], accv[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acck[i] = accv[i] = 0.0f;

  for (int it = 0; it < steps; ++it) {
    if (it + 1 < steps) load_q(it + 1);
    sm90::cp_async_commit();
    sm90::cp_async_wait<1>();  // step it (and k, v) have landed
    __syncthreads();
    const bf16* qs = ring + (it % kTcStages) * kStage;
    const bf16* dos = qs + kDkvStream * D;
    const float* ls = lds + (it % kTcStages) * 2 * kDkvStream;
    const float* ds = ls + kDkvStream;
    const int q0 = (qt0 + it % per_head) * kDkvStream;
    // The warpgroup skips a tile wholly above its diagonal or past n.
    if (wk0 < n && (!causal || q0 + kDkvStream - 1 >= wk0)) {
      // Transposed scores: rows are keys, columns queries.
      float s[kDkvStream / 2], dp[kDkvStream / 2];
      sm90::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        sm90::mma_ss<kDkvStream>(
            s, sm90::desc_k<kTcOwn>(ks, kTcRows * th.wg, kk),
            sm90::desc_k<kDkvStream>(qs, 0, kk), kk);
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        sm90::mma_ss<kDkvStream>(
            dp, sm90::desc_k<kTcOwn>(vs, kTcRows * th.wg, kk),
            sm90::desc_k<kDkvStream>(dos, 0, kk), kk);
      sm90::wgmma_commit();
      sm90::wgmma_wait<0>();
      sm90::fence_regs(s);
      sm90::fence_regs(dp);
#pragma unroll
      for (int j = 0; j < kDkvStream / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int kpos = wk0 + th.r0 + 8 * (e / 2);
          const int col = 8 * j + th.c0 + e % 2;
          const int qpos = q0 + col;
          const bool ok = qpos < n && kpos < n && (!causal || kpos <= qpos);
          const float p = ok ? exp2f(fmaf(s[4 * j + e], sl2,
                                          -ls[col] * kLog2e))
                             : 0.0f;
          s[4 * j + e] = p;
          dp[4 * j + e] = p * (dp[4 * j + e] - ds[col]);  // t
        }
      {
        uint32_t hi[kDkvStream / 16][4], lo[kDkvStream / 16][4];
        sm90::pack_a<kDkvStream>(s, hi, lo);
        sm90::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kDkvStream / 16; ++kk) {
          sm90::mma_rs_t<D>(accv, hi[kk],
                            sm90::desc_mn<kDkvStream>(dos, kk), 1);
          sm90::mma_rs_t<D>(accv, lo[kk],
                            sm90::desc_mn<kDkvStream>(dos, kk), 1);
        }
        sm90::wgmma_commit();
        sm90::wgmma_wait<0>();
        sm90::fence_regs(accv);
        sm90::fence_regs(hi);
        sm90::fence_regs(lo);
      }
      {
        uint32_t hi[kDkvStream / 16][4], lo[kDkvStream / 16][4];
        sm90::pack_a<kDkvStream>(dp, hi, lo);
        sm90::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kDkvStream / 16; ++kk) {
          sm90::mma_rs_t<D>(acck, hi[kk], sm90::desc_mn<kDkvStream>(qs, kk),
                            1);
          sm90::mma_rs_t<D>(acck, lo[kk], sm90::desc_mn<kDkvStream>(qs, kk),
                            1);
        }
        sm90::wgmma_commit();
        sm90::wgmma_wait<0>();
        sm90::fence_regs(acck);
        sm90::fence_regs(hi);
        sm90::fence_regs(lo);
      }
    }
    if ((it + 1) % kDkvFlush == 0 || it + 1 == steps) {
      // Move the tensor cores' partial sums into dk, dv with float32
      // round-to-nearest adds, and start the next partial at 0.
      const bool first = it + 1 <= kDkvFlush;
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int row = wk0 + th.r0 + 8 * i;
        if (row >= n) continue;
        // The row's addresses are made here, not kept across the loop:
        // kept, they spilled (dk/dv at d = 128 holds 255 registers).
        float* dkb = dk;
        float* dvb = dv;
        asm volatile("" : "+l"(dkb), "+l"(dvb));
        const size_t at = ikv * head + static_cast<size_t>(row) * D + th.c0;
#pragma unroll
        for (int j = 0; j < D / 8; ++j) {
          float2* k2 = reinterpret_cast<float2*>(dkb + at + 8 * j);
          float2* v2 = reinterpret_cast<float2*>(dvb + at + 8 * j);
          const float2 k_was = first ? make_float2(0.0f, 0.0f) : *k2;
          const float2 v_was = first ? make_float2(0.0f, 0.0f) : *v2;
          *k2 = make_float2(k_was.x + scale * acck[4 * j + 2 * i],
                            k_was.y + scale * acck[4 * j + 2 * i + 1]);
          *v2 = make_float2(v_was.x + accv[4 * j + 2 * i],
                            v_was.y + accv[4 * j + 2 * i + 1]);
        }
      }
#pragma unroll
      for (int i = 0; i < D / 2; ++i) acck[i] = accv[i] = 0.0f;
    }
    __syncthreads();  // the stage is read before step it + 2 refills it
  }
}

float scale_for(int d) {
  // 1/sqrt(d) in double, rounded once to float, as a float32 tensor times
  // the Python float 1.0 / math.sqrt(d).
  return static_cast<float>(1.0 / std::sqrt(static_cast<double>(d)));
}

template <int D>
int launch_dq(const void* q, const void* k, const void* v, const void* dout,
              const void* lse, const void* delta, void* dq, int h, int hkv,
              int n, int causal, cudaStream_t stream) {
  const size_t smem =
      sizeof(float) * (4 * kBlock * (D + 1) + kBlock * kScoreLd);
  cudaError_t e = allow_smem(flash_hop_dq_kernel<D>, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid((n + kBlock - 1) / kBlock, h);
  flash_hop_dq_kernel<D><<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<float*>(dq), h, hkv, n, causal, scale_for(D));
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_dkv(const void* q, const void* k, const void* v, const void* dout,
               const void* lse, const void* delta, void* dk, void* dv, int h,
               int hkv, int n, int causal, cudaStream_t stream) {
  const size_t smem = sizeof(float) * (4 * kBlock * (D + 1) +
                                       2 * kBlock * kScoreLd + 2 * kBlock);
  cudaError_t e = allow_smem(flash_hop_dkv_kernel<D>, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid((n + kBlock - 1) / kBlock, hkv);
  flash_hop_dkv_kernel<D><<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<float*>(dk), static_cast<float*>(dv), h, hkv, n, causal,
      scale_for(D));
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_dq_tc(const void* q, const void* k, const void* v,
                 const void* dout, const void* lse, const void* delta,
                 void* dq, int h, int hkv, int n, int causal,
                 cudaStream_t stream) {
  constexpr size_t smem = dq_smem<D>();
  cudaError_t e = allow_smem(flash_hop_dq_tc<D>, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid(h, (n + kTcOwn - 1) / kTcOwn);
  flash_hop_dq_tc<D><<<grid, kTcThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<float*>(dq), h, hkv, n, causal, scale_for(D));
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_dkv_tc(const void* q, const void* k, const void* v,
                  const void* dout, const void* lse, const void* delta,
                  void* dk, void* dv, int h, int hkv, int n, int causal,
                  cudaStream_t stream) {
  constexpr size_t smem = dkv_smem<D>();
  cudaError_t e = allow_smem(flash_hop_dkv_tc<D>, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid(hkv, (n + kTcOwn - 1) / kTcOwn);
  flash_hop_dkv_tc<D><<<grid, kTcThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<float*>(dk), static_cast<float*>(dv), h, hkv, n, causal,
      scale_for(D));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dq (h, n, d, float32) of q, do (h, n, d) against k, v (hkv, n, d) and
// lse, delta (h, n, float32), on `stream`. dtype 0 = float32, 1 = bfloat16;
// d 64 or 128. Returns 0, a CUDA error code, or -1 for an unsupported dtype
// or d.
extern "C" int flash_hop_dq(const void* q, const void* k, const void* v,
                            const void* dout, const void* lse,
                            const void* delta, void* dq, int h, int hkv,
                            int n, int d, int causal, int dtype,
                            void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && d == 64)
    return launch_dq<64>(q, k, v, dout, lse, delta, dq, h, hkv, n,
                                causal, s);
  if (dtype == 0 && d == 128)
    return launch_dq<128>(q, k, v, dout, lse, delta, dq, h, hkv, n,
                                 causal, s);
  if (dtype == 1 && d == 64)
    return launch_dq_tc<64>(q, k, v, dout, lse, delta, dq, h, hkv, n, causal,
                            s);
  if (dtype == 1 && d == 128)
    return launch_dq_tc<128>(q, k, v, dout, lse, delta, dq, h, hkv, n,
                             causal, s);
  return -1;
}

// dk, dv (hkv, n, d, float32), each summed over its K/V head's g query
// heads; arguments as flash_hop_dq's.
extern "C" int flash_hop_dkv(const void* q, const void* k, const void* v,
                             const void* dout, const void* lse,
                             const void* delta, void* dk, void* dv, int h,
                             int hkv, int n, int d, int causal, int dtype,
                             void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && d == 64)
    return launch_dkv<64>(q, k, v, dout, lse, delta, dk, dv, h, hkv,
                                 n, causal, s);
  if (dtype == 0 && d == 128)
    return launch_dkv<128>(q, k, v, dout, lse, delta, dk, dv, h, hkv,
                                  n, causal, s);
  if (dtype == 1 && d == 64)
    return launch_dkv_tc<64>(q, k, v, dout, lse, delta, dk, dv, h, hkv, n,
                             causal, s);
  if (dtype == 1 && d == 128)
    return launch_dkv_tc<128>(q, k, v, dout, lse, delta, dk, dv, h, hkv, n,
                              causal, s);
  return -1;
}

// The CUDA runtime's attributes of the kernel flash_hop_dq (dkv = 0) or
// flash_hop_dkv (dkv = 1) launches for d and dtype, as
// flash_fwd_attributes gives them.
extern "C" int flash_hop_attributes(int dkv, int d, int dtype, int* out) {
  if (dtype == 0 && d == 64)
    return dkv ? flash::func_attributes(flash_hop_dkv_kernel<64>, out)
               : flash::func_attributes(flash_hop_dq_kernel<64>, out);
  if (dtype == 0 && d == 128)
    return dkv ? flash::func_attributes(flash_hop_dkv_kernel<128>, out)
               : flash::func_attributes(flash_hop_dq_kernel<128>, out);
  if (dtype == 1 && d == 64)
    return dkv ? flash::func_attributes(flash_hop_dkv_tc<64>, out)
               : flash::func_attributes(flash_hop_dq_tc<64>, out);
  if (dtype == 1 && d == 128)
    return dkv ? flash::func_attributes(flash_hop_dkv_tc<128>, out)
               : flash::func_attributes(flash_hop_dq_tc<128>, out);
  return -1;
}

extern "C" const char* flash_hop_bwd_error(int code) {
  if (code == -1) return "unsupported dtype or head_dim";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
