// The lifting DWT on Hopper: what the forward (X2) and reverse (X4)
// kernels share.
//
// One launch per level. A CTA owns a 64x64 tile of the level's plane and
// reads a halo of its neighbours' samples: a lifting step reads the two
// neighbours along its axis, so the tile's own outputs after every step of
// a level need 2 samples a side for 5/3 and 4 for 9/7 (the chains reach 2
// / 4 positions left and 1 / 3 right forward, 1 / 3 left and 2 / 4 right
// back; the left halo is rounded up to keep the tile even-aligned). Halo
// positions compute values that are not used; positions past the plane's
// edge are loaded as 0 and never read by an in-plane position, because
// the neighbour rule is the port's `_nxt` (the odd position at the plane's
// end reads its left even twice) and `_prv` (the even position 0 reads its
// right odd twice), taken on the position's index in the level's plane:
// exactly `transform/dwt.py`.
//
// X4 lifts its tile in shared memory, a step at a time (`lift_step`): one
// pass over the positions of one parity and a __syncthreads(); a step
// writes only that parity and reads only the other, so a pass has no
// races. X2 lifts strips of 16 positions (plus the halo) in registers
// (`lift_regs`), every step of a level fully unrolled, with the edge rule
// as a select only in strips that reach the plane's first or last
// position. The 9/7 arithmetic rounds once per JAX op through explicit
// round-to-nearest intrinsics (__fadd_rn, __fmul_rn, __fdiv_rn,
// __fmaf_rn), which nvcc never contracts or reorders.
//
// What bounds these kernels on an H100: bytes. A level reads its plane
// (+13% of halo for 5/3, +27% for 9/7) and writes its subbands; the bound
// counts the samples read once and the codeblocks written once
// (transform/dwt_cuda.py `bound_ms`), the intermediate LL planes (a third
// of a plane more each way) and the halos are this design's cost. At
// 2048^2 the deep levels' planes are a few tiles, so their launches are
// latency-bound: one CTA's chain of loads, barriers and stores.
#pragma once

#include <cstdint>
#include <type_traits>
#include <cuda_runtime.h>

namespace picsong {
namespace dwt {

constexpr int kTile = 64;           // a CTA's tile of the level's plane
constexpr int kThreads = 256;
constexpr int kBlockSide = 64;      // spec.CBLOCK_WIDTH, CBLOCK_LENGTH
constexpr int kBlockWords = kBlockSide * kBlockSide;
constexpr unsigned kFullMask = 0xffffffffu;

template <bool kLossy>
struct Tile {
  static constexpr int kHalo = kLossy ? 4 : 2;
  static constexpr int kSide = kTile + 2 * kHalo;   // rows and columns
  using V = typename std::conditional<kLossy, float, int32_t>::type;
};

// The sample types, as the C entry points take them
// (transform/dwt_cuda.py _SAMPLE_TYPES).
enum SampleType { kU8 = 0, kI8 = 1, kU16 = 2, kI16 = 3 };

// The float32 constants of one level, from the wrapper's array (its
// layout: alpha, beta, gamma, delta, K1, K2, the reconstruction factor,
// the rounding bias, qs, the 3x3 ICT of the direction row-major, then per
// level the gains of LL, HL, LH, HH -- times qs forward).
struct Consts {
  float alpha, beta, gamma, delta, k1, k2, recon, bias, qs;
  float ict[9];
  float gain[4];
};

inline Consts level_consts(const float* host, int level) {
  Consts c;
  c.alpha = host[0];
  c.beta = host[1];
  c.gamma = host[2];
  c.delta = host[3];
  c.k1 = host[4];
  c.k2 = host[5];
  c.recon = host[6];
  c.bias = host[7];
  c.qs = host[8];
  for (int i = 0; i < 9; ++i) c.ict[i] = host[9 + i];
  for (int i = 0; i < 4; ++i) c.gain[i] = host[18 + 4 * level + i];
  return c;
}

// A kernel parameter array indexed at run time would be copied to local
// memory; these select its element instead.
__device__ __forceinline__ float pick3(float a, float b, float c, int i) {
  return i == 0 ? a : (i == 1 ? b : c);
}

__device__ __forceinline__ float gain_of(const Consts& c, int band) {
  return band == 0 ? c.gain[0]
                   : (band == 1 ? c.gain[1] : (band == 2 ? c.gain[2]
                                                         : c.gain[3]));
}

__device__ __forceinline__ int32_t load_sample(const void* p, int64_t i,
                                               int type) {
  switch (type) {
    case kU8: return static_cast<const uint8_t*>(p)[i];
    case kI8: return static_cast<const int8_t*>(p)[i];
    case kU16: return static_cast<const uint16_t*>(p)[i];
    default: return static_cast<const int16_t*>(p)[i];
  }
}

__device__ __forceinline__ void store_sample(void* p, int64_t i, int type,
                                             int32_t v) {
  switch (type) {
    case kU8: static_cast<uint8_t*>(p)[i] = static_cast<uint8_t>(v); break;
    case kI8: static_cast<int8_t*>(p)[i] = static_cast<int8_t>(v); break;
    case kU16: static_cast<uint16_t*>(p)[i] = static_cast<uint16_t>(v); break;
    default: static_cast<int16_t*>(p)[i] = static_cast<int16_t>(v); break;
  }
}

// The word of Mallat position (y, x) of a plane `bx` codeblocks wide, in
// warpID-ordered codeblocks: block (y / 64) * bx + x / 64, offset
// (y % 64) * 64 + x % 64 (core/geometry.py plane_to_codeblocks).
__device__ __forceinline__ int64_t block_word(int y, int x, int bx) {
  return static_cast<int64_t>((y >> 6) * bx + (x >> 6)) * kBlockWords +
         (y & (kBlockSide - 1)) * kBlockSide + (x & (kBlockSide - 1));
}

// One lifting step along an axis of the tile t (kSide x kSide, row-major):
// every position of parity `par` on lines [l0, l1) across the axis becomes
// f(x, a, b) of itself and its neighbours a (left) and b (right); g0 is
// the plane index of tile position 0 along the axis, n the plane's length.
// An odd position reads the evens beside it, the right one replaced by the
// left at the plane's end (`_nxt`); an even one the odds beside it, the
// left replaced by the right at the plane's start (`_prv`). At the tile's
// edge (a halo position, whose value is not used) the same replacement
// keeps the read inside the tile. Consecutive threads take consecutive
// columns: along the vertical axis lines, along the horizontal positions.
template <int kSide, bool kVert, class V, class F>
__device__ __forceinline__ void lift_step(V* t, int par, int l0, int l1,
                                          int g0, int n, F f) {
  constexpr int kHalf = kSide / 2;
  constexpr int kStride = kVert ? kSide : 1;
  const int lines = l1 - l0;
  for (int i = threadIdx.x; i < kHalf * lines; i += kThreads) {
    int pos, line;
    if (kVert) {
      line = l0 + i % lines;
      pos = 2 * (i / lines) + par;
    } else {
      pos = 2 * (i % kHalf) + par;
      line = l0 + i / kHalf;
    }
    const int g = g0 + pos;
    int a, b;
    if (par) {
      a = pos - 1;
      b = (g + 1 < n && pos + 1 < kSide) ? pos + 1 : pos - 1;
    } else {
      b = pos + 1;
      a = (g > 0 && pos > 0) ? pos - 1 : pos + 1;
    }
    V* base = t + (kVert ? line : line * kSide);
    base[pos * kStride] = f(base[pos * kStride], base[a * kStride],
                            base[b * kStride]);
  }
  __syncthreads();
}

// One lifting step on a strip v of N consecutive positions along an axis,
// held in registers (X2): every index of parity kPar becomes f(x, a, b) of
// itself and its neighbours a (left) and b (right), with lift_step's
// neighbour rule. With kEdge, `lo` and `hi` are the indices of the plane's
// first and last position (either may lie outside the strip): the odd
// index before `hi` + 1 reads its left even twice (`_nxt`), the even index
// at `lo` its right odd (`_prv`); without, the strip lies strictly inside
// the plane and no select is made. At the strip's own ends (halo
// positions, whose values are not used) the read stays inside the strip.
template <int kPar, bool kEdge, int N, class V, class F>
__device__ __forceinline__ void lift_regs(V (&v)[N], int lo, int hi, F f) {
#pragma unroll
  for (int i = kPar; i < N; i += 2) {
    V a = v[i > 0 ? i - 1 : i + 1];
    V b = v[i + 1 < N ? i + 1 : i - 1];
    if constexpr (kEdge) {
      if constexpr (kPar) b = i < hi ? b : a;
      else a = i > lo ? a : b;
    }
    v[i] = f(v[i], a, b);
  }
}

// Forward lifting of a register strip (`dwt._fwd53` / `_fwd97`): the steps
// of lift_step's forward chain in the same order and arithmetic, the odd
// positions' final `* K1` only with kScaleOdd (the horizontal pass folds
// it into the store).
template <bool kLossy, bool kEdge, bool kScaleOdd, class V, int N>
__device__ __forceinline__ void lift_forward_regs(V (&v)[N], int lo, int hi,
                                                  const Consts& c) {
  static_assert(std::is_same<V, typename Tile<kLossy>::V>::value,
                "int32 for 5/3, float for 9/7");
  if constexpr (!kLossy) {
    lift_regs<1, kEdge>(v, lo, hi, [](int32_t x, int32_t a, int32_t b) {
      return x - ((a + b) >> 1);
    });
    lift_regs<0, kEdge>(v, lo, hi, [](int32_t x, int32_t a, int32_t b) {
      return x + ((a + b + 2) >> 2);
    });
  } else {
    const float al = c.alpha, be = c.beta, ga = c.gamma, de = c.delta;
    const float k2 = c.k2;
    lift_regs<1, kEdge>(v, lo, hi, [=](float x, float a, float b) {
      return __fadd_rn(x, __fmul_rn(__fadd_rn(a, b), al));
    });
    lift_regs<0, kEdge>(v, lo, hi, [=](float x, float a, float b) {
      return __fadd_rn(x, __fmul_rn(__fadd_rn(a, b), be));
    });
    lift_regs<1, kEdge>(v, lo, hi, [=](float x, float a, float b) {
      return __fadd_rn(x, __fmul_rn(__fadd_rn(a, b), ga));
    });
    lift_regs<0, kEdge>(v, lo, hi, [=](float x, float a, float b) {
      return __fmul_rn(__fadd_rn(x, __fmul_rn(__fadd_rn(a, b), de)), k2);
    });
    if constexpr (kScaleOdd) {
#pragma unroll
      for (int i = 1; i < N; i += 2) v[i] = __fmul_rn(v[i], c.k1);
    }
  }
}

// Inverse lifting along one axis (`dwt._inv53` / `_inv97`), the odd
// positions' first `/ K1` only when `scale_odd` (the horizontal pass folds
// it into the load).
template <bool kLossy, bool kVert>
__device__ __forceinline__ void lift_reverse(typename Tile<kLossy>::V* t,
                                             int l0, int l1, int g0, int n,
                                             const Consts& c, bool scale_odd) {
  constexpr int S = Tile<kLossy>::kSide;
  if constexpr (!kLossy) {
    lift_step<S, kVert>(t, 0, l0, l1, g0, n, [](int32_t x, int32_t a,
                                                int32_t b) {
      return x - ((a + b + 2) >> 2);
    });
    lift_step<S, kVert>(t, 1, l0, l1, g0, n, [](int32_t x, int32_t a,
                                                int32_t b) {
      return x + ((a + b) >> 1);
    });
  } else {
    const float al = c.alpha, be = c.beta, ga = c.gamma, de = c.delta;
    const float k1 = c.k1, k2 = c.k2;
    if (scale_odd)
      lift_step<S, kVert>(t, 1, l0, l1, g0, n,
                          [=](float x, float, float) { return __fdiv_rn(x, k1); });
    lift_step<S, kVert>(t, 0, l0, l1, g0, n, [=](float x, float a, float b) {
      return __fsub_rn(__fdiv_rn(x, k2), __fmul_rn(__fadd_rn(a, b), de));
    });
    lift_step<S, kVert>(t, 1, l0, l1, g0, n, [=](float x, float a, float b) {
      return __fsub_rn(x, __fmul_rn(__fadd_rn(a, b), ga));
    });
    lift_step<S, kVert>(t, 0, l0, l1, g0, n, [=](float x, float a, float b) {
      return __fsub_rn(x, __fmul_rn(__fadd_rn(a, b), be));
    });
    lift_step<S, kVert>(t, 1, l0, l1, g0, n, [=](float x, float a, float b) {
      return __fsub_rn(x, __fmul_rn(__fadd_rn(a, b), al));
    });
  }
}

}  // namespace dwt
}  // namespace picsong
