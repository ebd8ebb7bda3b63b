// flash_common.cuh: what the float32 (FMA) flash attention kernels of
// flash_fwd.cu and flash_hop_bwd.cu share: the tile shape, loads of a
// float32 tile into shared memory, the two products of float32 tiles in
// shared memory, and the row reductions across the 16 threads that share a
// row; and kNeg, which the bf16 kernels use too.
//
// Layout of a block's 256 threads over a 64-row tile: thread (tx, ty) =
// (tid % 16, tid / 16) owns rows ty + 16 i (i < 4) and, of a 64-column
// score tile, columns tx + 16 j (j < 4); of a d-wide output tile, columns
// tx + 16 j (j < d / 16). The 16 threads of a row are one half-warp, so a
// row's max or sum is four xor-shuffles.
//
// Tiles of d columns are stored with a row stride of d + 1 words (d = 64
// or 128), and score tiles with 65: a warp's reads down a column (16
// rows tx, one word each) then fall in 16 distinct banks, and reads
// along a row in consecutive banks; the two rows a warp reads at once
// (ty even and odd) differ by one bank. No bank conflicts, no swizzle.
#pragma once

#include <cuda_runtime.h>

#include <cstddef>

namespace flash {

constexpr int kBlock = 64;             // rows of a q tile and of a k tile
constexpr int kThreads = 256;          // 16 x 16
constexpr int kRows = kBlock / 16;     // rows (and score columns) per thread
constexpr int kScoreLd = kBlock + 1;   // row stride of a 64 x 64 score tile
constexpr float kNeg = -1e30f;         // parallel/context.py:_NEG

__device__ __forceinline__ int tid_x() { return threadIdx.x & 15; }
__device__ __forceinline__ int tid_y() { return threadIdx.x >> 4; }

// Rows [row0, row0 + kBlock) of a (rows, D) row-major matrix into a
// kBlock x (D + 1) float32 tile; rows at or past `rows` read as 0.
// Neighbouring threads read neighbouring elements.
template <int D>
__device__ __forceinline__ void load_tile(float* dst,
                                          const float* __restrict__ src,
                                          int row0, int rows) {
  for (int i = threadIdx.x; i < kBlock * D; i += kThreads) {
    const int r = i / D;
    const int c = i % D;
    dst[r * (D + 1) + c] =
        row0 + r < rows ? src[static_cast<size_t>(row0 + r) * D + c] : 0.0f;
  }
}

// acc[i][j] += sum_c A[ty + 16 i][c] * B[tx + 16 j][c]: a 64 x 64 tile of
// A Bᵀ, both kBlock x D tiles of stride D + 1.
template <int D>
__device__ __forceinline__ void dot_nt(const float* A, const float* B,
                                       float (&acc)[kRows][kRows]) {
  const int tx = tid_x(), ty = tid_y();
#pragma unroll 8
  for (int c = 0; c < D; ++c) {
    float a[kRows], b[kRows];
#pragma unroll
    for (int i = 0; i < kRows; ++i) a[i] = A[(ty + 16 * i) * (D + 1) + c];
#pragma unroll
    for (int j = 0; j < kRows; ++j) b[j] = B[(tx + 16 * j) * (D + 1) + c];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int j = 0; j < kRows; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
  }
}

// acc[i][j] += sum_r P[ty + 16 i][r] * B[r][tx + 16 j]: a 64 x D tile of
// P B, P a 64 x 64 score tile (stride kScoreLd), B a kBlock x D tile.
template <int D>
__device__ __forceinline__ void dot_nn(const float* P, const float* B,
                                       float (&acc)[kRows][D / 16]) {
  const int tx = tid_x(), ty = tid_y();
#pragma unroll 4
  for (int r = 0; r < kBlock; ++r) {
    float a[kRows], b[D / 16];
#pragma unroll
    for (int i = 0; i < kRows; ++i) a[i] = P[(ty + 16 * i) * kScoreLd + r];
#pragma unroll
    for (int j = 0; j < D / 16; ++j) b[j] = B[r * (D + 1) + tx + 16 * j];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int j = 0; j < D / 16; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
  }
}

// Max and sum over the 16 threads (one half-warp) that share a row.
__device__ __forceinline__ float row_max(float x) {
#pragma unroll
  for (int off = 8; off; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float row_sum(float x) {
#pragma unroll
  for (int off = 8; off; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// Opt a kernel into more than 48 KB of dynamic shared memory.
template <typename K>
inline cudaError_t allow_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

// The CUDA runtime's record of a built kernel (cudaFuncGetAttributes) into
// out: registers a thread, local (spilled) bytes a thread, static shared
// bytes, and the dynamic shared bytes a launch may take, which allow_smem
// sets at the kernel's launches.
template <typename K>
inline int func_attributes(K kernel, int* out) {
  cudaFuncAttributes a;
  const cudaError_t e = cudaFuncGetAttributes(&a, kernel);
  if (e != cudaSuccess) return static_cast<int>(e);
  out[0] = a.numRegs;
  out[1] = static_cast<int>(a.localSizeBytes);
  out[2] = static_cast<int>(a.sharedSizeBytes);
  out[3] = a.maxDynamicSharedSizeBytes;
  return 0;
}

}  // namespace flash
