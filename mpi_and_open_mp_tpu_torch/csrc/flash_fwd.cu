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
// One block per (64-row q tile, query head); grid (q tiles, h), the
// heaviest causal tiles (the last) first. The block stages its q tile in
// shared memory and walks the k tiles - under causal only those not wholly
// above the diagonal - staging each k and v tile, computing the 64 x 64
// score tile in registers, and folding it into the running max m, sum l
// and output o with the online softmax of parallel/context.py:
// _block_update: s masked to kNeg (kpos >= n, and kpos > qpos under
// causal), m' = max(m, rowmax s), p = exp(s - m') on allowed entries and 0
// elsewhere, l' = l exp(m - m') + rowsum p, o' = o exp(m - m') + p v. The
// running max starts at the finite kNeg, never -inf. At the end o / l is
// written in q's dtype and L = m + log(max(l, 1e-37)) in float32 (-kNeg
// for a row with l = 0); rows at or past n are never written. Inputs
// (float32 or bfloat16) become float32 in shared memory, and every product
// and sum is float32 on the FMA units; exp is the accurate expf.
//
// Bound on the H100: operations. The causal forward does 2 h n^2 d
// multiply-adds (2.2 TFLOP at 8 x 32768 x 128), 2.2 ms at the 989 TFLOP/s
// bf16 tensor-core peak, against 0.08 ms for its bytes. This first kernel
// runs its products on the FP32 units from shared memory (67 TFLOP/s peak,
// and about 2 FMAs per shared-memory load), so it stays far from that
// bound; wgmma tiles with TMA loads are the way there (a later PR).
#include "flash_common.cuh"

#include <cmath>

namespace {

using namespace flash;

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o,
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
  const T* kh = k + ikv * head;
  const T* vh = v + ikv * head;

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
    T* orow = o + ih * head + static_cast<size_t>(row) * D;
#pragma unroll
    for (int c = 0; c < kCols; ++c)
      orow[tx + 16 * c] = from_f32<T>(acc[i][c] / den);
    if (tx == 0)
      lse[static_cast<size_t>(ih) * n + row] =
          l[i] > 0.0f ? m[i] + logf(fmaxf(l[i], 1e-37f)) : -kNeg;
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* o, void* lse,
           int h, int hkv, int n, int causal, cudaStream_t stream) {
  const size_t smem =
      sizeof(float) * (3 * kBlock * (D + 1) + kBlock * kScoreLd);
  cudaError_t e = allow_smem(flash_fwd_kernel<T, D>, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  // scale = 1/sqrt(d) in double, rounded once to float, as a float32
  // tensor times the Python float 1.0 / math.sqrt(d).
  const float scale = static_cast<float>(1.0 / std::sqrt(static_cast<double>(D)));
  const dim3 grid((n + kBlock - 1) / kBlock, h);
  flash_fwd_kernel<T, D><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), static_cast<float*>(lse),
      h, hkv, n, causal, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Attention forward of q (h, n, d) over k, v (hkv, n, d) into o (h, n, d,
// q's dtype) and lse (h, n, float32), on `stream`. dtype 0 = float32,
// 1 = bfloat16; d 64 or 128. Returns 0, a CUDA error code, or -1 for an
// unsupported dtype or d.
extern "C" int flash_fwd(const void* q, const void* k, const void* v,
                         void* o, void* lse, int h, int hkv, int n, int d,
                         int causal, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && d == 64)
    return launch<float, 64>(q, k, v, o, lse, h, hkv, n, causal, s);
  if (dtype == 0 && d == 128)
    return launch<float, 128>(q, k, v, o, lse, h, hkv, n, causal, s);
  if (dtype == 1 && d == 64)
    return launch<__nv_bfloat16, 64>(q, k, v, o, lse, h, hkv, n, causal, s);
  if (dtype == 1 && d == 128)
    return launch<__nv_bfloat16, 128>(q, k, v, o, lse, h, hkv, n, causal, s);
  return -1;
}

extern "C" const char* flash_fwd_error(int code) {
  if (code == -1) return "unsupported dtype or head_dim";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
