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
// (64 q rows of one query head) walks the k tiles of its K/V head; the
// dk/dv block (64 k rows of one K/V head) walks, for each of the g query
// heads of that K/V head, the q tiles, which is where GQA's group sum
// happens. Under causal, tiles wholly above the diagonal are skipped. The
// JAX kernels take GQA K/V pre-expanded and L, D lane-broadcast to 128
// lanes (the TPU's layout); these take them as they are. Their plain
// version is parallel/context.py:_flash_block_grads over chunked blocks
// (ops/flash_hop_bwd.py:hop_block_grads_plain).
//
// Inputs (float32 or bfloat16) become float32 in shared memory; every
// product and sum is float32 on the FMA units (the JAX kernels feed the
// MXU p and t rounded to the input dtype; float32 here is closer to the
// plain version). exp is the accurate expf.
//
// Bound on the H100: operations. Causal, dq does three products of
// h n^2 d / 2 multiply-adds each (s, do vᵀ, t k) and dk/dv four (s, v doᵀ,
// pᵀ do, tᵀ q): 3.3 and 4.4 TFLOP at 8 x 32768 x 128, 3.3 and 4.4 ms at
// the 989 TFLOP/s bf16 tensor-core peak, against about 0.1 ms for their
// bytes. Like flash_fwd, this first version runs on the FP32 units from
// shared memory and stays far from it.
#include "flash_common.cuh"

#include <cmath>

namespace {

using namespace flash;

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_hop_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
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
  const T* kh = k + ikv * head;
  const T* vh = v + ikv * head;

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

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_hop_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ dout,
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

float scale_for(int d) {
  // 1/sqrt(d) in double, rounded once to float, as a float32 tensor times
  // the Python float 1.0 / math.sqrt(d).
  return static_cast<float>(1.0 / std::sqrt(static_cast<double>(d)));
}

template <typename T, int D>
int launch_dq(const void* q, const void* k, const void* v, const void* dout,
              const void* lse, const void* delta, void* dq, int h, int hkv,
              int n, int causal, cudaStream_t stream) {
  const size_t smem =
      sizeof(float) * (4 * kBlock * (D + 1) + kBlock * kScoreLd);
  cudaError_t e = allow_smem(flash_hop_dq_kernel<T, D>, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid((n + kBlock - 1) / kBlock, h);
  flash_hop_dq_kernel<T, D><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<float*>(dq), h, hkv, n, causal, scale_for(D));
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int D>
int launch_dkv(const void* q, const void* k, const void* v, const void* dout,
               const void* lse, const void* delta, void* dk, void* dv, int h,
               int hkv, int n, int causal, cudaStream_t stream) {
  const size_t smem = sizeof(float) * (4 * kBlock * (D + 1) +
                                       2 * kBlock * kScoreLd + 2 * kBlock);
  cudaError_t e = allow_smem(flash_hop_dkv_kernel<T, D>, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid((n + kBlock - 1) / kBlock, hkv);
  flash_hop_dkv_kernel<T, D><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout),
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
    return launch_dq<float, 64>(q, k, v, dout, lse, delta, dq, h, hkv, n,
                                causal, s);
  if (dtype == 0 && d == 128)
    return launch_dq<float, 128>(q, k, v, dout, lse, delta, dq, h, hkv, n,
                                 causal, s);
  if (dtype == 1 && d == 64)
    return launch_dq<__nv_bfloat16, 64>(q, k, v, dout, lse, delta, dq, h,
                                        hkv, n, causal, s);
  if (dtype == 1 && d == 128)
    return launch_dq<__nv_bfloat16, 128>(q, k, v, dout, lse, delta, dq, h,
                                         hkv, n, causal, s);
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
    return launch_dkv<float, 64>(q, k, v, dout, lse, delta, dk, dv, h, hkv,
                                 n, causal, s);
  if (dtype == 0 && d == 128)
    return launch_dkv<float, 128>(q, k, v, dout, lse, delta, dk, dv, h, hkv,
                                  n, causal, s);
  if (dtype == 1 && d == 64)
    return launch_dkv<__nv_bfloat16, 64>(q, k, v, dout, lse, delta, dk, dv,
                                         h, hkv, n, causal, s);
  if (dtype == 1 && d == 128)
    return launch_dkv<__nv_bfloat16, 128>(q, k, v, dout, lse, delta, dk, dv,
                                          h, hkv, n, causal, s);
  return -1;
}

extern "C" const char* flash_hop_bwd_error(int code) {
  if (code == -1) return "unsupported dtype or head_dim";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
