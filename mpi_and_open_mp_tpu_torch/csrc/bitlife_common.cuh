// Shared device code of the two bit-packed Life kernels (bitlife_vmem.cu,
// bitlife_fused.cu): one packed Life step over a window held in shared
// memory.
//
// Layout: 32 board rows per 32-bit word along y. A window is R word rows
// by C columns, row-major. Both axes wrap at the window's edge: on a whole
// board (the resident kernel) that is the torus; on a halo window (the
// fused kernel) the wrap feeds junk in at the edges, one bit row and one
// column per step, which never reaches the valid interior within the
// halo's depth.
//
// The rule is the carry-save adder form of mpi_and_open_mp_tpu/ops/
// bitlife.py:_carry_save_rule: 2-bit column sums, a mod-8 neighbour count
// (centre excluded; N == 8 wraps to 0 and dies), then (n0 | c) & n1 & ~n2.
// life_word recomputes the y shifts and the 3-cell sums of the side columns
// for every word, about 49 two-input operations per 32 cells, which nvcc
// merges into funnel shifts (SHF) and 3-input logic (LOP3). The fewest
// sm_90 instructions known for the rule are 17 per word with those sums
// shared between neighbouring columns (chip_smoke.py:OPS_PER_WORD_STEP).
#pragma once

#include <cstdint>

namespace bitlife {

// One packed word of the next state, from the 3x3 block of words around
// it: a* is the word row above (lower bit positions), m* the centre row,
// b* the row below; *L, *C, *R the left, centre and right columns.
__device__ __forceinline__ uint32_t life_word(
    uint32_t aL, uint32_t aC, uint32_t aR,
    uint32_t mL, uint32_t mC, uint32_t mR,
    uint32_t bL, uint32_t bC, uint32_t bR) {
  // Neighbours at y-1 ("dn") and y+1 ("up") of every bit, for each column.
  const uint32_t dnL = (mL << 1) | (aL >> 31), upL = (mL >> 1) | (bL << 31);
  const uint32_t dnC = (mC << 1) | (aC >> 31), upC = (mC >> 1) | (bC << 31);
  const uint32_t dnR = (mR << 1) | (aR >> 31), upR = (mR >> 1) | (bR << 31);
  // Centre column: up + dn (centre excluded).
  const uint32_t cs0 = upC ^ dnC, cs1 = upC & dnC;
  // Side columns: up + centre + dn.
  const uint32_t lx = upL ^ dnL, ly = upL & dnL;
  const uint32_t l0 = lx ^ mL, l1 = ly | (lx & mL);
  const uint32_t rx = upR ^ dnR, ry = upR & dnR;
  const uint32_t r0 = rx ^ mR, r1 = ry | (rx & mR);
  // P = L + R (3 bits).
  const uint32_t p0 = l0 ^ r0, q0 = l0 & r0;
  const uint32_t p1x = l1 ^ r1;
  const uint32_t p1 = p1x ^ q0;
  const uint32_t p2 = (l1 & r1) | (p1x & q0);
  // N = P + centre column, mod 8.
  const uint32_t n0 = p0 ^ cs0, rc = p0 & cs0;
  const uint32_t n1x = p1 ^ cs1;
  const uint32_t n1 = n1x ^ rc;
  const uint32_t n2 = p2 ^ ((p1 & cs1) | (n1x & rc));
  return (n0 | mC) & n1 & ~n2;
}

// One step of the R x C window src into dst (both in shared memory). The
// block's threads split the window into vertical strips: a thread owns one
// column and a run of rows, and slides a 3x3 register window down it, so
// each word costs three shared-memory loads. When the window is narrower
// than the block, the rows split into segments so that every thread works.
__device__ __forceinline__ void window_step(
    const uint32_t* __restrict__ src, uint32_t* __restrict__ dst,
    int R, int C) {
  const int T = blockDim.x, t = threadIdx.x;
  int nseg = T / C;
  nseg = nseg < 1 ? 1 : (nseg > R ? R : nseg);
  int seg, c0, cstride;
  if (nseg > 1) {
    seg = t / C;
    c0 = t - seg * C;
    cstride = C;
    if (seg >= nseg) return;
  } else {
    seg = 0;
    c0 = t;
    cstride = T;
  }
  const int r0 = seg * R / nseg, r1 = (seg + 1) * R / nseg;
  for (int c = c0; c < C; c += cstride) {
    const int cl = c == 0 ? C - 1 : c - 1;
    const int cr = c == C - 1 ? 0 : c + 1;
    const uint32_t* ra = src + (r0 == 0 ? R - 1 : r0 - 1) * C;
    const uint32_t* rm = src + r0 * C;
    uint32_t aL = ra[cl], aC = ra[c], aR = ra[cr];
    uint32_t mL = rm[cl], mC = rm[c], mR = rm[cr];
    for (int r = r0; r < r1; ++r) {
      const uint32_t* rb = src + (r == R - 1 ? 0 : r + 1) * C;
      const uint32_t bL = rb[cl], bC = rb[c], bR = rb[cr];
      dst[r * C + c] = life_word(aL, aC, aR, mL, mC, mR, bL, bC, bR);
      aL = mL; aC = mC; aR = mR;
      mL = bL; mC = bC; mR = bR;
    }
  }
}

}  // namespace bitlife
