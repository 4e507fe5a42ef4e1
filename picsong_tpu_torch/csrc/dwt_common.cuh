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
// Both kernels lift strips of 16 positions (plus the halo) in registers
// (`lift_regs`), every step of a level fully unrolled: X2 columns, then
// rows; X4 rows, then columns. The edge rule is a select only in strips
// that reach the plane's first or last position. A CTA's threads meet at
// a barrier between the passes, never inside one. The 9/7 arithmetic
// rounds once per JAX op through explicit round-to-nearest intrinsics
// (__fadd_rn, __fsub_rn, __fmul_rn, __fmaf_rn), which nvcc never contracts
// or reorders, and divides through `div_rn`.
//
// Shard mode (the kShard variants, `dist/sharded.py`): one launch lifts
// one level of the rows [r0, r1) of a taller plane, from a buffer holding
// the plane rows [in0, in1): the shard's rows and the halo its neighbours
// lend it (X2: HALO rows; X4: HALO / 2 band rows; none past the plane's
// top or bottom). Rows are counted from the plane's top, so the edge rule
// fires only at the plane's first and last row. Rows outside the buffer
// load as 0 and reach only halo positions, since the halo is the lifting's
// whole reach; only rows [r0, r1) are stored: X2 as row-major band rows,
// X4 as rows of the next level's plane or of samples. The whole-plane
// variants are the same code with r0 = in0 = 0 and r1 = in1 = the plane's
// height as constants.
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
constexpr int kStrip = 16;          // positions a thread lifts a pass
constexpr int kStrips = kTile / kStrip;
constexpr int kBlockSide = 64;      // spec.CBLOCK_WIDTH, CBLOCK_LENGTH
constexpr int kBlockWords = kBlockSide * kBlockSide;
constexpr unsigned kFullMask = 0xffffffffu;

template <bool kLossy>
struct Tile {
  static constexpr int kHalo = kLossy ? 4 : 2;
  using V = typename std::conditional<kLossy, float, int32_t>::type;
};

// The sample types, as the C entry points take them
// (transform/dwt_cuda.py _SAMPLE_TYPES); kValues: a shard-mode X2 input of
// int32 (5/3) or float (9/7) values, taken as they are (no prep).
enum SampleType { kU8 = 0, kI8 = 1, kU16 = 2, kI16 = 3, kValues = 4 };

// Pointer i (known only at run time) of a kernel parameter array, by
// selects: indexing the array would copy it to local memory.
template <class P, int N>
__device__ __forceinline__ P pick_ptr(const P (&p)[N], int i) {
  P out = p[0];
#pragma unroll
  for (int k = 1; k < N; ++k) out = i == k ? p[k] : out;
  return out;
}

// The float32 constants of one level, from the wrapper's array (its
// layout: alpha, beta, gamma, delta, K1, K2, the reconstruction factor,
// the rounding bias, qs, the reciprocals 1 / K1, 1 / K2, 1 / qs, the 3x3
// ICT of the direction row-major, then per level the gains of LL, HL, LH,
// HH -- times qs forward -- and their reciprocals). Each reciprocal is the
// float32 quotient rounded once, as `div_rn` needs.
struct Consts {
  float alpha, beta, gamma, delta, k1, k2, recon, bias, qs;
  float rk1, rk2, rqs;
  float ict[9];
  float gain[4], rgain[4];
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
  c.rk1 = host[9];
  c.rk2 = host[10];
  c.rqs = host[11];
  for (int i = 0; i < 9; ++i) c.ict[i] = host[12 + i];
  for (int i = 0; i < 4; ++i) {
    c.gain[i] = host[21 + 8 * level + i];
    c.rgain[i] = host[21 + 8 * level + 4 + i];
  }
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

__device__ __forceinline__ float rgain_of(const Consts& c, int band) {
  return band == 0 ? c.rgain[0]
                   : (band == 1 ? c.rgain[1] : (band == 2 ? c.rgain[2]
                                                          : c.rgain[3]));
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

// The word of Mallat position (y, x) of a plane `bx` codeblocks wide, in
// warpID-ordered codeblocks: block (y / 64) * bx + x / 64, offset
// (y % 64) * 64 + x % 64 (core/geometry.py plane_to_codeblocks).
__device__ __forceinline__ int64_t block_word(int y, int x, int bx) {
  return static_cast<int64_t>((y >> 6) * bx + (x >> 6)) * kBlockWords +
         (y & (kBlockSide - 1)) * kBlockSide + (x & (kBlockSide - 1));
}

// x / b rounded once to nearest (as __fdiv_rn), from y = RN(1 / b), the
// wrapper's float32 reciprocal: q0 = x y is within an ulp and a half of
// x / b, q1 = q0 + (x - b q0) y rounded once is within an ulp (faithful),
// and one more such step rounds correctly (Markstein's theorem: y within
// half an ulp of 1 / b, the remainder x - b q exact). It holds where x, x /
// b and the remainders are normal floats (|x| above ~2^-100), as every
// value of a plane is; x = 0 keeps its sign. Five operations without a
// branch. With __fdiv_rn (a range check, and a slow path it calls for a
// zero dividend) X4's 9/7 took 0.110 ms at 2048^2 on an H100, with this
// 0.064 (tests/test_torch_dwt_cuda.py checks every mantissa for K1, K2).
__device__ __forceinline__ float div_rn(float x, float b, float y) {
  const float q0 = __fmul_rn(x, y);
  const float q1 = __fmaf_rn(__fmaf_rn(-q0, b, x), y, q0);
  const float q = __fmaf_rn(__fmaf_rn(-q1, b, x), y, q1);
  return x == 0.0f ? x : q;
}

// One lifting step on a strip v of N consecutive positions along an axis,
// held in registers: every index of parity kPar becomes f(x, a, b) of
// itself and its neighbours a (left) and b (right). With kEdge, `lo` and
// `hi` are the indices of the plane's first and last position (either may
// lie outside the strip): the odd index before `hi` + 1 reads its left
// even twice (`_nxt`), the even index at `lo` its right odd (`_prv`);
// without, the strip lies strictly inside the plane and no select is
// made. At the strip's own ends (halo
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

// Forward lifting of a register strip (`dwt._fwd53` / `_fwd97`), the odd
// positions' final `* K1` only with kScaleOdd (X2's horizontal pass folds
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

// Inverse lifting of a register strip (`dwt._inv53` / `_inv97`), the odd
// positions' first `/ K1` only with kScaleOdd (X4's horizontal pass folds
// it into the load).
template <bool kLossy, bool kEdge, bool kScaleOdd, class V, int N>
__device__ __forceinline__ void lift_reverse_regs(V (&v)[N], int lo, int hi,
                                                  const Consts& c) {
  static_assert(std::is_same<V, typename Tile<kLossy>::V>::value,
                "int32 for 5/3, float for 9/7");
  if constexpr (!kLossy) {
    lift_regs<0, kEdge>(v, lo, hi, [](int32_t x, int32_t a, int32_t b) {
      return x - ((a + b + 2) >> 2);
    });
    lift_regs<1, kEdge>(v, lo, hi, [](int32_t x, int32_t a, int32_t b) {
      return x + ((a + b) >> 1);
    });
  } else {
    const float al = c.alpha, be = c.beta, ga = c.gamma, de = c.delta;
    const float k1 = c.k1, k2 = c.k2, rk1 = c.rk1, rk2 = c.rk2;
    if constexpr (kScaleOdd) {
#pragma unroll
      for (int i = 1; i < N; i += 2) v[i] = div_rn(v[i], k1, rk1);
    }
    lift_regs<0, kEdge>(v, lo, hi, [=](float x, float a, float b) {
      return __fsub_rn(div_rn(x, k2, rk2), __fmul_rn(__fadd_rn(a, b), de));
    });
    lift_regs<1, kEdge>(v, lo, hi, [=](float x, float a, float b) {
      return __fsub_rn(x, __fmul_rn(__fadd_rn(a, b), ga));
    });
    lift_regs<0, kEdge>(v, lo, hi, [=](float x, float a, float b) {
      return __fsub_rn(x, __fmul_rn(__fadd_rn(a, b), be));
    });
    lift_regs<1, kEdge>(v, lo, hi, [=](float x, float a, float b) {
      return __fsub_rn(x, __fmul_rn(__fadd_rn(a, b), al));
    });
  }
}

}  // namespace dwt
}  // namespace picsong
