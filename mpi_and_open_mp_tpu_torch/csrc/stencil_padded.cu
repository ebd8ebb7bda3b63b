// stencil_padded: one step of a registered stencil rule over halo-padded
// blocks, (L, H, W) -> (L, H - 2r, W - 2r), the leading axis a stack of
// boards or the channels of one board.
//
// Replaces the TPU kernel mpi_and_open_mp_tpu/ops/pallas_life.py:
// stencil_step_padded_pallas.kernel, whose body is
// stencils/engine.py:step_padded over the whole block resident in VMEM
// (blocks past 4 MB fall back to jnp there). Here the board is tiled over
// thread blocks, so any extent runs: each block stages one 32 x 32 output
// tile plus its r-wide halo, for every channel, in shared memory, then
// each thread computes four cells' aggregates over the offset table and
// applies the rule. grid = (x tiles, y tiles, groups), a group being one
// board (C channel planes, C = 2 for gray_scott, else 1).
//
// The offset table (dy, dx, float bits of w), in the row-major order of
// stencils/engine.py:offsets, comes in at run time and is staged in shared
// memory beside the tile, so any make_lenia(r) runs without a rebuild.
// One device function per rule: life, heat, gray_scott, wireworld (its
// `pre` counts heads) and lenia. Integer rules load uint8 and compute in
// int32, as the TPU kernel's int32 cast does. Float rules round every
// operation on its own (__fadd_rn, __fmul_rn, ...), in the order of the
// rule bodies in stencils/spec.py, so nvcc contracts no a*b+c into an FMA
// the plain version does not have; expf is the accurate one (no
// --use_fast_math).
//
// Bound on the H100 (chip_smoke.py:stencil_bound_ms): bytes for heat and
// gray_scott (each input byte read once, each output byte written once:
// 38 us per step for heat at 64 x 500^2); INT32 operations for life and
// wireworld (the 8-tap sum and the rule at half the FP32 lane rate); FP32
// operations for lenia (2 per tap, 288 taps per cell at r = 8). What
// the design does about it: coalesced row loads into shared memory, so
// device memory sees each input about once (neighbour tiles' halos come
// from L2); taps read shared memory at one broadcast address per warp for
// the table and consecutive words for the field. A simple first kernel:
// no register blocking of taps across cells, no TMA.
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

namespace {

constexpr int kTileW = 32;
constexpr int kTileH = 32;
constexpr int kThreadsX = 32;
constexpr int kThreadsY = 8;
constexpr int kThreads = kThreadsX * kThreadsY;
constexpr int kRows = kTileH / kThreadsY;  // cells per thread

// Rule ids; ops/native_stencil.py:RULES holds the same numbers.
enum Rule { kLife = 0, kHeat = 1, kGrayScott = 2, kWireworld = 3, kLenia = 4 };

struct Tap {
  int dy, dx;
  float w;
};

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

template <int RULE>
__global__ void __launch_bounds__(kThreads)
stencil_padded_kernel(const void* __restrict__ in_, void* __restrict__ out_,
                      const int* __restrict__ table, int n_off, int groups,
                      int H, int W, int r) {
  constexpr bool kInt = RULE == kLife || RULE == kWireworld;
  constexpr int C = RULE == kGrayScott ? 2 : 1;
  using T = typename std::conditional<kInt, uint8_t, float>::type;
  using S = typename std::conditional<kInt, int, float>::type;
  const T* in = static_cast<const T*>(in_);
  T* out = static_cast<T*>(out_);

  const int h = H - 2 * r;
  const int w = W - 2 * r;
  const int SW = kTileW + 2 * r;
  const int SH = kTileH + 2 * r;
  const int plane_tile = SH * SW;

  extern __shared__ __align__(16) unsigned char smem[];
  Tap* taps = reinterpret_cast<Tap*>(smem);
  S* tile = reinterpret_cast<S*>(smem + sizeof(Tap) * n_off);

  const int tid = threadIdx.y * kThreadsX + threadIdx.x;
  for (int k = tid; k < n_off; k += kThreads) {
    taps[k].dy = table[3 * k];
    taps[k].dx = table[3 * k + 1];
    taps[k].w = __int_as_float(table[3 * k + 2]);
  }

  const int y0 = blockIdx.y * kTileH;
  const int x0 = blockIdx.x * kTileW;
  const size_t plane_in = static_cast<size_t>(H) * W;
  const size_t plane_out = static_cast<size_t>(h) * w;

  for (int g = blockIdx.z; g < groups; g += gridDim.z) {
    const T* gin = in + static_cast<size_t>(g) * C * plane_in;
    T* gout = out + static_cast<size_t>(g) * C * plane_out;
    __syncthreads();  // the table is staged; the last group's reads are done
    for (int c = 0; c < C; ++c) {
      for (int i = tid; i < plane_tile; i += kThreads) {
        const int gy = y0 + i / SW;
        const int gx = x0 + i % SW;
        S v = 0;
        if (gy < H && gx < W) {
          v = static_cast<S>(gin[c * plane_in + static_cast<size_t>(gy) * W + gx]);
          if constexpr (RULE == kWireworld) v = (v == 1);  // pre: heads only
        }
        tile[c * plane_tile + i] = v;
      }
    }
    __syncthreads();

    const int x = threadIdx.x;
    S agg[kRows][C];
    for (int k = 0; k < n_off; ++k) {
      const Tap t = taps[k];
      for (int j = 0; j < kRows; ++j) {
        const int y = threadIdx.y + j * kThreadsY;
        const int at = (y + r + t.dy) * SW + (x + r + t.dx);
        for (int c = 0; c < C; ++c) {
          const S v = tile[c * plane_tile + at];
          if constexpr (kInt) {
            agg[j][c] = (k ? agg[j][c] : 0) + static_cast<int>(t.w) * v;
          } else {
            const float term = t.w != 1.0f ? __fmul_rn(v, t.w) : v;
            agg[j][c] = k ? __fadd_rn(agg[j][c], term) : term;
          }
        }
      }
    }

    for (int j = 0; j < kRows; ++j) {
      const int y = threadIdx.y + j * kThreadsY;
      const int oy = y0 + y;
      const int ox = x0 + x;
      if (oy >= h || ox >= w) continue;
      const size_t o = static_cast<size_t>(oy) * w + ox;
      const int at = (y + r) * SW + (x + r);
      if constexpr (RULE == kLife) {
        gout[o] = life_rule(tile[at], agg[j][0]);
      } else if constexpr (RULE == kWireworld) {
        // The tile holds heads only; the rule needs the raw state.
        gout[o] = wireworld_rule(
            gin[(static_cast<size_t>(oy) + r) * W + ox + r], agg[j][0]);
      } else if constexpr (RULE == kHeat) {
        gout[o] = heat_rule(tile[at], agg[j][0]);
      } else if constexpr (RULE == kLenia) {
        gout[o] = lenia_rule(tile[at], agg[j][0]);
      } else {
        float un, vn;
        gray_scott_rule(tile[at], tile[plane_tile + at], agg[j][0],
                        agg[j][1], &un, &vn);
        gout[o] = un;
        gout[plane_out + o] = vn;
      }
    }
  }
}

template <int RULE>
int launch(const void* in, void* out, const void* table, int n_off,
           int groups, int H, int W, int r, cudaStream_t stream) {
  constexpr bool kInt = RULE == kLife || RULE == kWireworld;
  constexpr int C = RULE == kGrayScott ? 2 : 1;
  const int h = H - 2 * r;
  const int w = W - 2 * r;
  const size_t smem = sizeof(Tap) * n_off +
                      (kInt ? sizeof(int) : sizeof(float)) * C *
                          (kTileH + 2 * r) * (kTileW + 2 * r);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        stencil_padded_kernel<RULE>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const dim3 grid((w + kTileW - 1) / kTileW, (h + kTileH - 1) / kTileH,
                  groups < 65535 ? groups : 65535);
  stencil_padded_kernel<RULE><<<grid, dim3(kThreadsX, kThreadsY), smem,
                                stream>>>(
      in, out, static_cast<const int*>(table), n_off, groups, H, W, r);
  return static_cast<int>(cudaGetLastError());
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

extern "C" const char* stencil_padded_error(int code) {
  if (code == -1) return "unknown stencil rule";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
