// flash_sm90.cuh: Hopper (sm_90a) building blocks of the tensor-core
// attention kernels: 16-byte cp.async loads of bf16 tiles into shared
// memory in the 128-byte swizzle, the wgmma shared-memory descriptors of
// such tiles, the warpgroup product m64nNk16 bf16 -> f32 (A from shared
// memory or from registers), and the split of float32 values into a bf16
// hi + lo pair.
//
// Tile layout. A tile of R rows x D bf16 columns (D = 64 or 128) is kept as
// D / 64 panels of 64 columns; panel c / 64 starts at (c / 64) * R * 128
// bytes, row r of a panel at r * 128 bytes, and 16-byte chunk j of the row
// (columns 8 j .. 8 j + 7) at chunk j ^ (r % 8): the 128-byte swizzle, with
// every panel 1024-byte aligned. The same bytes serve as a K-major operand
// (the contraction runs along the columns: s = q kᵀ with k as B) and as an
// MN-major one (the contraction runs along the rows: dq = t k with k as B).
// Descriptors (PTX ISA, "Matrix Descriptor Format"): K-major, a k16 step
// moves the start 32 bytes along the row inside a panel (the hardware
// swizzles the address), 8-row groups lie SBO = 1024 bytes apart, LBO
// unused (1); MN-major, a k16 step moves the start 16 rows (2048 bytes),
// 8-row groups SBO = 1024 bytes apart, and the next 64 columns (the next
// panel) LBO = R * 128 bytes away.
//
// Fragments of one warpgroup (128 threads; warp w, lane l, r = 16 w + l / 4,
// c = 2 (l % 4)): an m64nN float32 accumulator d holds d[4 j + e] at row
// r + 8 (e / 2), column 8 j + c + e % 2; a bf16 A operand of one k16 step
// holds, as four registers of two values, (r, c), (r + 8, c), (r, c + 8),
// (r + 8, c + 8). So columns 16 kk .. 16 kk + 15 of an accumulator are the
// A operand of k step kk of the next product (pack_a).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace sm90 {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// p moved up to the next 1024-byte boundary of shared memory, where a
// swizzled tile must start.
__device__ __forceinline__ char* align1024(char* p) {
  return p + ((1024 - (smem_addr(p) & 1023)) & 1023);
}

// Thread t of warpgroup wg: accumulator rows r0 and r0 + 8 of the
// warpgroup's 64, columns c0, c0 + 1 of every 8 (fragments above).
struct TcThread {
  int wg, r0, c0;
  __device__ TcThread()
      : wg(threadIdx.x / 128),
        r0(16 * (threadIdx.x % 128 / 32) + threadIdx.x % 32 / 4),
        c0(2 * (threadIdx.x % 4)) {}
};

// 16 bytes from global to shared memory, asynchronously; zeros when !valid
// (src is then not read).
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

// 4 bytes, as cp_async16.
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N committed groups of this thread are in flight, then
// make the landed bytes visible to the tensor cores' (async) proxy.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Byte offset of 16-byte chunk j (columns 8 j .. 8 j + 7) of row r in a
// swizzled tile of R rows (layout above).
template <int R>
__device__ __forceinline__ int chunk_at(int r, int j) {
  return (j / 8) * (R * 128) + r * 128 + (((j % 8) ^ (r % 8)) << 4);
}

// Rows [row0, row0 + R) of a row-major (rows, D) bf16 matrix into a
// swizzled R x D tile (layout above), by `threads` threads from `tid`;
// rows at or past `rows` read as 0.
template <int R, int D>
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst,
                                          const __nv_bfloat16* src, int row0,
                                          int rows, int tid, int threads) {
  constexpr int kChunks = D / 8;  // 16-byte chunks of a row
  char* base = reinterpret_cast<char*>(dst);
  for (int i = tid; i < R * kChunks; i += threads) {
    const int r = i / kChunks, j = i % kChunks;
    const bool ok = row0 + r < rows;
    const __nv_bfloat16* from =
        ok ? src + static_cast<size_t>(row0 + r) * D + 8 * j : src;
    cp_async16(base + chunk_at<R>(r, j), from, ok);
  }
}

// The 8 values of chunk j of row r of a swizzled R-row tile, as float32.
template <int R>
__device__ __forceinline__ void read_chunk(float (&x)[8],
                                           const __nv_bfloat16* tile, int r,
                                           int j) {
  const uint4 w = *reinterpret_cast<const uint4*>(
      reinterpret_cast<const char*>(tile) + chunk_at<R>(r, j));
  const uint32_t words[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(&words[i]));
    x[2 * i] = f.x;
    x[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16 |
         static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32 |
         1ull << 62;  // 128-byte swizzle
}

// K-major descriptor of k16 step kk of a tile at `tile` (rows of the tile
// from `row`, a multiple of 8).
template <int R>
__device__ __forceinline__ uint64_t desc_k(const __nv_bfloat16* tile, int row,
                                           int kk) {
  const uint32_t a =
      smem_addr(tile) + (kk / 4) * (R * 128) + row * 128 + (kk % 4) * 32;
  return desc_sw128(a, 16, 1024);
}

// MN-major descriptor of k16 step kk (rows 16 kk .. 16 kk + 15) of an
// R-row tile.
template <int R>
__device__ __forceinline__ uint64_t desc_mn(const __nv_bfloat16* tile,
                                            int kk) {
  return desc_sw128(smem_addr(tile) + kk * 2048, R * 128, 1024);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keep the compiler from moving reads or writes of registers that an
// asynchronous product owns across its issue and its wait.
template <int M>
__device__ __forceinline__ void fence_regs(float (&d)[M]) {
#pragma unroll
  for (int i = 0; i < M; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
template <int M>
__device__ __forceinline__ void fence_regs(uint32_t (&a)[M][4]) {
#pragma unroll
  for (int i = 0; i < M; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(a[i][j])::"memory");
}

// x = hi + lo + O(2^-16 |x|): hi = bf16(x), lo = bf16(x - hi).
__device__ __forceinline__ void split2(float x0, float x1, uint32_t& hi,
                                      uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const __nv_bfloat162 l = __floats2bfloat162_rn(
      x0 - __low2float(h), x1 - __high2float(h));
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

// The A operands (hi and lo) of the next product from the columns of an
// m64nN accumulator: k step kk takes columns 16 kk .. 16 kk + 15.
template <int N>
__device__ __forceinline__ void pack_a(const float (&d)[N / 2],
                                       uint32_t (&hi)[N / 16][4],
                                       uint32_t (&lo)[N / 16][4]) {
#pragma unroll
  for (int kk = 0; kk < N / 16; ++kk)
#pragma unroll
    for (int i = 0; i < 4; ++i)
      split2(d[8 * kk + 2 * i], d[8 * kk + 2 * i + 1], hi[kk][i], lo[kk][i]);
}

// d (m64nN, float32) = A B (+ d when accumulate), A and B bf16 K-major in
// shared memory (descriptors a, b).
template <int N>
__device__ void mma_ss(float (&d)[N / 2], uint64_t a, uint64_t b,
                       int accumulate);

// d (m64nN, float32) = A B (+ d when accumulate), A bf16 in registers (one
// k16 step, layout above), B bf16 MN-major in shared memory.
template <int N>
__device__ void mma_rs_t(float (&d)[N / 2], const uint32_t (&a)[4],
                         uint64_t b, int accumulate);

template <>
__device__ __forceinline__ void mma_ss<64>(float (&d)[32], uint64_t a,
                                           uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(accumulate));
}

template <>
__device__ __forceinline__ void mma_rs_t<64>(float (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b),
        "r"(accumulate));
}

template <>
__device__ __forceinline__ void mma_rs_t<128>(float (&d)[64],
                                             const uint32_t (&a)[4],
                                             uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39,"
      " %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55,"
      " %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b),
        "r"(accumulate));
}

}  // namespace sm90
