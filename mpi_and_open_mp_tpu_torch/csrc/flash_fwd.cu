// flash_fwd: attention forward, o = softmax(q kᵀ·scale) v, and the per-row
// logsumexp L = m + log l of the scaled scores, for q (h, n, d) and k, v
// (hkv, n, d), hkv dividing h (GQA: query head i reads K/V head i / g).
//
// Replaces the flash forward the JAX package runs on a TPU:
// mpi_and_open_mp_tpu/parallel/context.py:_pallas_flash (the single-device
// dispatch) and :_hop_flash_block (a ring hop's (o, L) partial), both
// calling JAX's bundled Pallas kernel. Its plain version is
// parallel/context.py:_flash_forward (ops/native_flash.py:flash_fwd_plain).
//
// Semantics, both kernels: the online softmax of parallel/context.py:
// _block_update over k tiles of 64 keys. s is masked (kpos >= n, and kpos
// > qpos under causal), m' = max(m, rowmax s), p = exp(s - m') on allowed
// entries and 0 elsewhere, l' = l exp(m - m') + rowsum p, o' = o exp(m -
// m') + p v. The running max starts at the finite kNeg, never -inf. At
// the end o / l is written in q's dtype and L = m + log(max(l, 1e-37)) in
// float32 (-kNeg for a row with l = 0); rows at or past n are never
// written. Under causal, k tiles wholly above the diagonal are skipped, and
// the heaviest q tiles (the last) start first.
//
// Bound on the H100: operations. The causal forward does 2 h n^2 d
// multiply-adds (2.2 TFLOP at 8 x 32768 x 128), 2.2 ms at the 989 TFLOP/s
// bf16 tensor-core peak, against 0.08 ms for its bytes.
//
// bf16 operands (flash_fwd_tc) run the products on the tensor cores
// (flash_sm90.cuh). A block owns 128 q rows of one query head, two
// warpgroups of 64; its q tile is loaded once and stays in shared memory,
// and k, v tiles of 64 keys stream by 16-byte cp.async, in the 128-byte
// swizzle, through a ring of four stages: tile i + 1 loads while tile i's
// k and tile i - 1's v are read, and the stage refilled was read two steps
// before, so the block meets at one barrier a step. A warpgroup skips a
// tile wholly above its own diagonal, and masks only on its diagonal tile
// and on the tile that holds n. s = q kᵀ runs as wgmma m64n64k16 with both
// operands K-major from shared memory; the online softmax runs in
// registers on the accumulator's fragments, where each row's 64 values lie
// in the four threads of a quad (two xor-shuffles for its max, two for its
// sum). It works in log2 units: x = s·scale·log2 e, m the running max of
// x, p = exp2(x - m) (exactly 1 at the row's max: the first row of a
// causal o is v_0 bit for bit), corr = exp2(m - m'); at the end L = m·ln 2
// + log l, in natural units, since the hop kernels read it. p stays in
// registers as the A operand of o += p v (wgmma m64nDk16, v MN-major).
// The JAX kernel and SDPA round p to bf16 once for that product; emulated
// on the CPU, that misses the bf16 rule chip_smoke.py holds o to (2 bf16
// spacings + 1e-3 of the row's largest |o|) more than twice over (tests/
// test_torch_attention.py:test_fwd_split_products_within_the_gate). So p
// is split, hi = bf16(p) and lo = bf16(p - hi), and the second product
// runs on both into one float32 accumulator: three products a tile where
// the work has two, 3.3 TFLOP executed at 32k for the 2.2 of the bound; l
// sums the unsplit p in float32. The steps are software-pipelined: step i
// issues s of tile i and p v of tile i - 1 together and runs tile i's
// softmax while the tensor cores sum p v, so the softmax no longer waits
// in line with its own warpgroup's products. The warpgroup index is
// broadcast from lane 0 so that the compiler sees its branches as
// warp-uniform; otherwise ptxas serialises the wgmma pipeline. Loads are
// cp.async, not TMA: without mbarrier waits a fault cannot hang the card.
// A producer warp with TMA, the two warpgroups ping-ponging softmax
// against products, and a wider k step are left open.
//
// float32 operands keep the first, FMA design (not redesigned): one block
// of 256 threads per 64-row q tile, q, k, v and the 64 x 64 probability
// tile as float32 rows in shared memory, every product on the FP32 units
// (67 TFLOP/s peak, about 2 FMAs per shared-memory load), exp the accurate
// expf.
#include "flash_common.cuh"
#include "flash_sm90.cuh"

#include <cmath>

namespace {

using namespace flash;

// ------------------------------------------------------------- float32:
// the FMA kernel.

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ o,
                 float* __restrict__ lse, int h, int hkv, int n, int causal,
                 float scale) {
  constexpr int kCols = D / 16;
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;
  float* ks = qs + kBlock * (D + 1);
  float* vs = ks + kBlock * (D + 1);
  float* ps = vs + kBlock * (D + 1);

  const int tiles = (n + kBlock - 1) / kBlock;
  const int qt = tiles - 1 - static_cast<int>(blockIdx.x);
  const int ih = blockIdx.y;
  const int ikv = ih / (h / hkv);
  const int q0 = qt * kBlock;
  const int tx = tid_x(), ty = tid_y();
  const size_t head = static_cast<size_t>(n) * D;
  const float* kh = k + ikv * head;
  const float* vh = v + ikv * head;

  load_tile<D>(qs, q + ih * head, q0, n);

  float acc[kRows][kCols];
  float m[kRows], l[kRows];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    m[i] = kNeg;
    l[i] = 0.0f;
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[i][c] = 0.0f;
  }

  // A k tile is live iff its first key is at or before the q tile's last
  // query; with equal tile edges that is kt <= qt.
  const int kt_end = causal ? qt + 1 : tiles;
  for (int kt = 0; kt < kt_end; ++kt) {
    const int k0 = kt * kBlock;
    __syncthreads();  // the last tile's reads of ks, vs, ps are done
    load_tile<D>(ks, kh, k0, n);
    load_tile<D>(vs, vh, k0, n);
    __syncthreads();

    float s[kRows][kRows];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int j = 0; j < kRows; ++j) s[i][j] = 0.0f;
    dot_nt<D>(qs, ks, s);

#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int qpos = q0 + ty + 16 * i;
      bool ok[kRows];
      float tile_max = kNeg;
#pragma unroll
      for (int j = 0; j < kRows; ++j) {
        const int kpos = k0 + tx + 16 * j;
        ok[j] = kpos < n && (!causal || kpos <= qpos);
        s[i][j] = ok[j] ? s[i][j] * scale : kNeg;
        tile_max = fmaxf(tile_max, s[i][j]);
      }
      const float m_new = fmaxf(m[i], row_max(tile_max));
      float sum = 0.0f;
#pragma unroll
      for (int j = 0; j < kRows; ++j) {
        const float p = ok[j] ? expf(s[i][j] - m_new) : 0.0f;
        ps[(ty + 16 * i) * kScoreLd + tx + 16 * j] = p;
        sum += p;
      }
      const float corr = expf(m[i] - m_new);
      l[i] = l[i] * corr + row_sum(sum);
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < kCols; ++c) acc[i][c] *= corr;
    }
    __syncthreads();
    dot_nn<D>(ps, vs, acc);
  }

#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= n) continue;
    const float den = l[i] > 0.0f ? l[i] : 1.0f;
    float* orow = o + ih * head + static_cast<size_t>(row) * D;
#pragma unroll
    for (int c = 0; c < kCols; ++c)
      orow[tx + 16 * c] = acc[i][c] / den;
    if (tx == 0)
      lse[static_cast<size_t>(ih) * n + row] =
          l[i] > 0.0f ? m[i] + logf(fmaxf(l[i], 1e-37f)) : -kNeg;
  }
}

// ---------------------------------------------------------------- bf16:
// the tensor-core kernel.

using bf16 = __nv_bfloat16;
using sm90::TcThread;

constexpr int kTcRows = 64;                  // q rows of a warpgroup
constexpr int kTcGroups = 2;                 // warpgroups of a block
constexpr int kTcThreads = 128 * kTcGroups;
constexpr int kTcOwn = kTcRows * kTcGroups;  // q rows a block owns
constexpr int kKStep = 64;                   // keys of a streamed tile
constexpr int kTcStages = 4;                 // the k, v tiles' ring
// A k tile is a warpgroup's height: the causal diagonal is one whole tile
// of each warpgroup.
static_assert(kKStep == kTcRows, "one diagonal tile per warpgroup");
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// Shared memory of a block (ops/native_flash.py:smem_bytes): 1024 bytes to
// align the tiles, the owned q tile, and per stage a k and a v tile.
template <int D>
constexpr size_t tc_smem() {
  return 1024 + kTcOwn * D * 2 + kTcStages * 2 * kKStep * D * 2;
}

// The online softmax of one score tile, in place: s (q kᵀ in the
// accumulator's layout, rows `row` and row + 8 of this thread) becomes p,
// and the thread's running max m (log2 units), sum l and rescale corr of
// its two rows move on. Masked entries read -inf, so p = exp2(-inf) = 0
// there, exactly; m starts at the finite kNeg, so m' is never -inf.
template <bool kMask>
__device__ __forceinline__ void online_softmax(float (&s)[kKStep / 2],
                                               float (&m)[2], float (&l)[2],
                                               float (&corr)[2], float sl2,
                                               int row, int k0, int n,
                                               int causal, int c0) {
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int j = 0; j < kKStep / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float x = s[4 * j + e] * sl2;
      if (kMask) {
        const int col = k0 + 8 * j + c0 + e % 2;
        if (col >= n || (causal && col > row + 8 * (e / 2))) x = -INFINITY;
      }
      s[4 * j + e] = x;
      mx[e / 2] = fmaxf(mx[e / 2], x);
    }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
    const float m_new = fmaxf(m[i], mx[i]);
    corr[i] = exp2f(m[i] - m_new);
    m[i] = m_new;
  }
  float sum[2] = {0.0f, 0.0f};
#pragma unroll
  for (int j = 0; j < kKStep / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float p = exp2f(s[4 * j + e] - m[e / 2]);
      s[4 * j + e] = p;
      sum[e / 2] += p;
    }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    sum[i] += __shfl_xor_sync(0xffffffffu, sum[i], 1);
    sum[i] += __shfl_xor_sync(0xffffffffu, sum[i], 2);
    l[i] = l[i] * corr[i] + sum[i];
  }
}

template <int D>
__global__ void __launch_bounds__(kTcThreads, 1)
flash_fwd_tc(const bf16* __restrict__ q, const bf16* __restrict__ k,
             const bf16* __restrict__ v, bf16* __restrict__ o,
             float* __restrict__ lse, int h, int hkv, int n, int causal,
             float scale) {
  constexpr int kStage = 2 * kKStep * D;  // elements: k tile, v tile
  extern __shared__ char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(sm90::align1024(smem_raw));
  bf16* ring = qs + kTcOwn * D;

  const int ih = blockIdx.x;
  const int tiles = (n + kTcOwn - 1) / kTcOwn;
  const int q0 = (tiles - 1 - static_cast<int>(blockIdx.y)) * kTcOwn;
  const size_t head = static_cast<size_t>(n) * D;
  const bf16* kh = k + (ih / (h / hkv)) * head;
  const bf16* vh = v + (ih / (h / hkv)) * head;
  const TcThread th;
  const int tid = threadIdx.x;
  // The warpgroup, broadcast from lane 0 so that the compiler knows it is
  // the same across the warp: branches on it do not diverge.
  const int wg = __shfl_sync(0xffffffffu, th.wg, 0);
  const int wq0 = q0 + kTcRows * wg;  // the warpgroup's first q row
  const int row = wq0 + th.r0;        // the thread's first row
  const int ksteps =
      ((causal ? min(q0 + kTcOwn, n) : n) + kKStep - 1) / kKStep;

  // The warpgroup's live tiles: under causal up to its diagonal tile.
  const int wsteps =
      wq0 >= n ? 0 : causal ? min(ksteps, wq0 / kKStep + 1) : ksteps;

  auto load_kv = [&](int kt) {
    bf16* st = ring + (kt % kTcStages) * kStage;
    sm90::load_tile<kKStep, D>(st, kh, kt * kKStep, n, tid, kTcThreads);
    sm90::load_tile<kKStep, D>(st + kKStep * D, vh, kt * kKStep, n, tid,
                               kTcThreads);
  };
  sm90::load_tile<kTcOwn, D>(qs, q + ih * head, q0, n, tid, kTcThreads);
  load_kv(0);
  sm90::cp_async_commit();

  const float sl2 = scale * kLog2e;
  float m[2] = {kNeg, kNeg}, l[2] = {0.0f, 0.0f}, corr[2];
  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.0f;
  float s[kKStep / 2];                              // tile kt's s, then p
  uint32_t hi[kKStep / 16][4], lo[kKStep / 16][4];  // p of tile kt - 1

  // Step kt: tile kt + 1 starts loading into the stage of tile kt - 3,
  // whose v was read at step kt - 2, before every thread passed the last
  // barrier; then tile kt has landed.
  auto step_in = [&](int kt) {
    if (kt + 1 < ksteps) load_kv(kt + 1);
    sm90::cp_async_commit();
    sm90::cp_async_wait<1>();
    __syncthreads();
  };
  auto issue_s = [&](int kt) {
    const bf16* ks = ring + (kt % kTcStages) * kStage;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      sm90::mma_ss<kKStep>(s, sm90::desc_k<kTcOwn>(qs, kTcRows * wg, kk),
                           sm90::desc_k<kKStep>(ks, 0, kk), kk);
    sm90::wgmma_commit();
  };
  auto issue_pv = [&](int kt) {
    const bf16* vs = ring + (kt % kTcStages) * kStage + kKStep * D;
#pragma unroll
    for (int kk = 0; kk < kKStep / 16; ++kk) {
      sm90::mma_rs_t<D>(acc, hi[kk], sm90::desc_mn<kKStep>(vs, kk), 1);
      sm90::mma_rs_t<D>(acc, lo[kk], sm90::desc_mn<kKStep>(vs, kk), 1);
    }
    sm90::wgmma_commit();
  };
  auto softmax = [&](int kt) {
    sm90::fence_regs(s);
    const int k0 = kt * kKStep;
    if ((causal && k0 == wq0) || k0 + kKStep > n)  // diagonal, or holds n
      online_softmax<true>(s, m, l, corr, sl2, row, k0, n, causal, th.c0);
    else
      online_softmax<false>(s, m, l, corr, sl2, row, k0, n, causal, th.c0);
  };

  // A software pipeline over the warpgroup's tiles: step kt issues s of
  // tile kt and o += p v of tile kt - 1 together, and runs tile kt's
  // softmax while the tensor cores sum p v. Every step, live or not, meets
  // the other warpgroup at the same barrier.
  int kt = 0;
  if (wsteps > 0) {
    step_in(0);
    sm90::wgmma_fence();
    issue_s(0);
    sm90::wgmma_wait<0>();
    softmax(0);
    sm90::pack_a<kKStep>(s, hi, lo);
    for (kt = 1; kt < wsteps; ++kt) {
      step_in(kt);
      sm90::wgmma_fence();
      issue_s(kt);
      issue_pv(kt - 1);
      sm90::wgmma_wait<1>();  // s has landed; p v may still run
      softmax(kt);
      sm90::wgmma_wait<0>();
      sm90::fence_regs(acc);
      sm90::fence_regs(hi);
      sm90::fence_regs(lo);
#pragma unroll
      for (int i = 0; i < D / 2; ++i) acc[i] *= corr[i % 4 / 2];
      sm90::pack_a<kKStep>(s, hi, lo);
    }
    step_in(kt);
    sm90::wgmma_fence();
    issue_pv(kt - 1);
    sm90::wgmma_wait<0>();
    sm90::fence_regs(acc);
    sm90::fence_regs(hi);
    sm90::fence_regs(lo);
    ++kt;
  }
  for (; kt <= ksteps; ++kt) step_in(kt);

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = row + 8 * i;
    if (r >= n) continue;
    const float den = l[i] > 0.0f ? l[i] : 1.0f;
    bf16* out = o + ih * head + static_cast<size_t>(r) * D + th.c0;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(out + 8 * j) = __floats2bfloat162_rn(
          acc[4 * j + 2 * i] / den, acc[4 * j + 2 * i + 1] / den);
    if (th.c0 == 0)
      lse[static_cast<size_t>(ih) * n + r] =
          l[i] > 0.0f ? m[i] * kLn2 + logf(fmaxf(l[i], 1e-37f)) : -kNeg;
  }
}

// scale = 1/sqrt(d) in double, rounded once to float, as a float32 tensor
// times the Python float 1.0 / math.sqrt(d).
float scale_for(int d) {
  return static_cast<float>(1.0 / std::sqrt(static_cast<double>(d)));
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* o, void* lse,
           int h, int hkv, int n, int causal, cudaStream_t stream) {
  const size_t smem =
      sizeof(float) * (3 * kBlock * (D + 1) + kBlock * kScoreLd);
  cudaError_t e = allow_smem(flash_fwd_kernel<D>, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid((n + kBlock - 1) / kBlock, h);
  flash_fwd_kernel<D><<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o),
      static_cast<float*>(lse), h, hkv, n, causal, scale_for(D));
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_tc(const void* q, const void* k, const void* v, void* o,
              void* lse, int h, int hkv, int n, int causal,
              cudaStream_t stream) {
  constexpr size_t smem = tc_smem<D>();
  cudaError_t e = allow_smem(flash_fwd_tc<D>, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid(h, (n + kTcOwn - 1) / kTcOwn);
  flash_fwd_tc<D><<<grid, kTcThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(o),
      static_cast<float*>(lse), h, hkv, n, causal, scale_for(D));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Attention forward of q (h, n, d) over k, v (hkv, n, d) into o (h, n, d,
// q's dtype) and lse (h, n, float32), on `stream`. dtype 0 = float32 (the
// FMA kernel), 1 = bfloat16 (the tensor-core kernel); d 64 or 128. Returns
// 0, a CUDA error code, or -1 for an unsupported dtype or d.
extern "C" int flash_fwd(const void* q, const void* k, const void* v,
                         void* o, void* lse, int h, int hkv, int n, int d,
                         int causal, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && d == 64)
    return launch<64>(q, k, v, o, lse, h, hkv, n, causal, s);
  if (dtype == 0 && d == 128)
    return launch<128>(q, k, v, o, lse, h, hkv, n, causal, s);
  if (dtype == 1 && d == 64)
    return launch_tc<64>(q, k, v, o, lse, h, hkv, n, causal, s);
  if (dtype == 1 && d == 128)
    return launch_tc<128>(q, k, v, o, lse, h, hkv, n, causal, s);
  return -1;
}

// The CUDA runtime's attributes of the kernel flash_fwd launches for d and
// dtype (flash_common.cuh:func_attributes): out[4] = registers, local
// bytes, static and dynamic shared bytes. Returns 0, a CUDA error code, or
// -1 for an unsupported dtype or d.
extern "C" int flash_fwd_attributes(int d, int dtype, int* out) {
  if (dtype == 0 && d == 64)
    return flash::func_attributes(flash_fwd_kernel<64>, out);
  if (dtype == 0 && d == 128)
    return flash::func_attributes(flash_fwd_kernel<128>, out);
  if (dtype == 1 && d == 64)
    return flash::func_attributes(flash_fwd_tc<64>, out);
  if (dtype == 1 && d == 128)
    return flash::func_attributes(flash_fwd_tc<128>, out);
  return -1;
}

extern "C" const char* flash_fwd_error(int code) {
  if (code == -1) return "unsupported dtype or head_dim";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
