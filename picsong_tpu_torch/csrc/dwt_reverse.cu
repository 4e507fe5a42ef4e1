// X4 for Hopper (sm_90a): untiling, dequantization, the inverse lifting
// DWT and the finish (inverse colour transform, rounding, DC shift,
// clamp), one launch per level, deepest first.
//
// Replaces the XLA program of `picsong_tpu/engine/pipeline.py`
// `_untile_idwt_impl` (l.259) + `_finish_gray_impl` / `_finish_rgb_impl`
// (l.275/285): `picsong_tpu/transform/dwt.py:187` `dwt_reverse` (`dq`
// :198, levels :148, lifting :56/72/114/130) and `core/geometry.py:57`
// `codeblocks_to_plane`. Its plain version is `transform/dwt_cuda.py`
// `reverse_plain`.
//
// A CTA rebuilds one 64x64 tile of a level's plane:
//   - load, with the halo (dwt_common.cuh): position (gy, gx) of the plane
//     is band (gy odd, gx odd) at (gy / 2, gx / 2), read from codeblock
//     order, or for LL above the deepest level from the deeper level's
//     output. 9/7 dequantizes each codeblock value at the midpoint,
//     (|q| + 0.5) with q's sign, divided by the gain and then by qs, 0
//     kept 0 (dwt.py:230-239; the deepest LL too), and divides the odd
//     columns by K1, the horizontal synthesis's first step;
//   - horizontal inverse lifting on every row of the tile, then vertical
//     on its own columns;
//   - store: above level 0 into the plane the next launch reads as its LL;
//     at level 0 the finish into the sample planes. There a CTA rebuilds
//     the tile of every component of its frame in turn (keeping each in
//     registers), because the inverse colour transform mixes them:
//       gray lossless: x + offset;   gray lossy: rint((x + offset) + 0.01f);
//       RGB lossless (RCT): g = y - ((u + v) >> 2), r = v + g, b = u + g;
//       RGB lossy (ICT): rint(fma(m2, cr, fma(m1, cb, m0 * y)) + 0.01f) as
//       int32 (the oracle's chain, `dwt_cuda.fma_row`);
//     then (RGB: + offset) the clamp and the cast to the sample type.
#include "dwt_common.cuh"

namespace picsong {
namespace dwt {
namespace {

struct RevArgs {
  const int32_t* blocks[3];  // per component (batch, ncb, 64, 64)
  const void* ll_in;         // above the deepest level: its LL planes
  void* out;                 // this level's planes, or (level 0) samples
  int64_t plane_words;       // ncb * 4096
  int batch, comps;
  int h, w;                  // this level's plane
  int bx;                    // codeblock columns of the level-0 plane
  int deepest, offset, lo, hi, type;
  Consts c;
};

// Midpoint dequantization of codeblock value q of a band with this gain.
__device__ __forceinline__ float dequant(int32_t q, float gain,
                                         const Consts& c) {
  if (q == 0) return 0.0f;
  const float mag = __fadd_rn(static_cast<float>(abs(q)), c.recon);
  return __fdiv_rn(__fdiv_rn(q < 0 ? -mag : mag, gain), c.qs);
}

// Position (gy, gx) of component `comp` of frame `f`'s plane, before the
// synthesis.
template <bool kLossy>
__device__ __forceinline__ typename Tile<kLossy>::V load(const RevArgs& a,
                                                         int comp, int f,
                                                         int gy, int gx) {
  using V = typename Tile<kLossy>::V;
  const int dy = gy & 1, dx = gx & 1, band = dy * 2 + dx;
  const int y = gy >> 1, x = gx >> 1, h2 = a.h >> 1, w2 = a.w >> 1;
  V v;
  if (band == 0 && !a.deepest) {
    v = static_cast<const V*>(a.ll_in)[(static_cast<int64_t>(comp) * a.batch +
                                        f) * h2 * w2 + y * w2 + x];
  } else {
    const int32_t* blocks =
        comp == 0 ? a.blocks[0] : (comp == 1 ? a.blocks[1] : a.blocks[2]);
    const int32_t q = blocks[f * a.plane_words +
                             block_word(y + dy * h2, x + dx * w2, a.bx)];
    if constexpr (kLossy) v = dequant(q, gain_of(a.c, band), a.c);
    else v = q;
  }
  if constexpr (kLossy)
    if (dx) v = __fdiv_rn(v, a.c.k1);
  return v;
}

// The samples of one pixel from its reconstructed components.
template <bool kLossy, int kComps>
__device__ __forceinline__ void finish(const RevArgs& a,
                                       const typename Tile<kLossy>::V* v,
                                       int32_t* s) {
  if constexpr (kComps == 1) {
    if constexpr (kLossy) {
      const float x = rintf(__fadd_rn(
          __fadd_rn(v[0], static_cast<float>(a.offset)), a.c.bias));
      s[0] = static_cast<int32_t>(fminf(fmaxf(x, static_cast<float>(a.lo)),
                                        static_cast<float>(a.hi)));
    } else {
      s[0] = min(max(v[0] + a.offset, a.lo), a.hi);
    }
  } else {
    int32_t rgb[3];
    if constexpr (kLossy) {
#pragma unroll
      for (int k = 0; k < 3; ++k)
        rgb[k] = __float2int_rn(__fadd_rn(
            __fmaf_rn(v[2], a.c.ict[3 * k + 2],
                      __fmaf_rn(v[1], a.c.ict[3 * k + 1],
                                __fmul_rn(v[0], a.c.ict[3 * k]))),
            a.c.bias));
    } else {
      rgb[1] = v[0] - ((v[1] + v[2]) >> 2);
      rgb[0] = v[2] + rgb[1];
      rgb[2] = v[1] + rgb[1];
    }
#pragma unroll
    for (int k = 0; k < 3; ++k) s[k] = min(max(rgb[k] + a.offset, a.lo), a.hi);
  }
}

// kFinal: level 0, one CTA a frame's tile over its kComps components, the
// finish folded into the store; else one CTA a plane's tile (kComps 1).
template <bool kLossy, int kComps, bool kFinal>
__global__ void __launch_bounds__(kThreads)
dwt_reverse_kernel(const RevArgs a) {
  using T = Tile<kLossy>;
  using V = typename T::V;
  constexpr int S = T::kSide, H = T::kHalo;
  constexpr int kPer = kTile * kTile / kThreads;
  __shared__ V t[S * S];
  const int y0 = blockIdx.y * kTile, x0 = blockIdx.x * kTile;
  const int gy0 = y0 - H, gx0 = x0 - H;
  const int f = kFinal ? blockIdx.z : blockIdx.z % a.batch;
  V keep[kComps][kPer];
#pragma unroll
  for (int k = 0; k < kComps; ++k) {
    const int comp = kFinal ? k : blockIdx.z / a.batch;
    for (int i = threadIdx.x; i < S * S; i += kThreads) {
      const int gy = gy0 + i / S, gx = gx0 + i % S;
      t[i] = (gy >= 0 && gy < a.h && gx >= 0 && gx < a.w)
                 ? load<kLossy>(a, comp, f, gy, gx)
                 : V(0);
    }
    __syncthreads();
    lift_reverse<kLossy, false>(t, 0, S, gx0, a.w, a.c, false);
    lift_reverse<kLossy, true>(t, H, H + kTile, gy0, a.h, a.c, true);
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const int i = j * kThreads + threadIdx.x;
      const int r = i / kTile, c = i % kTile;
      const V v = t[(H + r) * S + H + c];
      if constexpr (kFinal) {
        keep[k][j] = v;
      } else if (y0 + r < a.h && x0 + c < a.w) {
        static_cast<V*>(a.out)[static_cast<int64_t>(blockIdx.z) * a.h * a.w +
                               (y0 + r) * a.w + x0 + c] = v;
      }
    }
    if (kComps > 1) __syncthreads();         // before the next load
  }
  if constexpr (kFinal) {
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const int i = j * kThreads + threadIdx.x;
      const int y = y0 + i / kTile, x = x0 + i % kTile;
      if (y >= a.h || x >= a.w) continue;
      V v[kComps];
      int32_t s[kComps];
#pragma unroll
      for (int k = 0; k < kComps; ++k) v[k] = keep[k][j];
      finish<kLossy, kComps>(a, v, s);
#pragma unroll
      for (int k = 0; k < kComps; ++k)
        store_sample(a.out, (static_cast<int64_t>(f) * kComps + k) * a.h * a.w +
                                y * a.w + x,
                     a.type, s[k]);
    }
  }
}

template <bool kLossy>
void launch_level(const RevArgs& a, int level, int planes, cudaStream_t s) {
  const dim3 grid((a.w + kTile - 1) / kTile, (a.h + kTile - 1) / kTile,
                  static_cast<unsigned>(level ? planes : a.batch));
  if (level)
    dwt_reverse_kernel<kLossy, 1, false><<<grid, kThreads, 0, s>>>(a);
  else if (a.comps == 3)
    dwt_reverse_kernel<kLossy, 3, true><<<grid, kThreads, 0, s>>>(a);
  else
    dwt_reverse_kernel<kLossy, 1, true><<<grid, kThreads, 0, s>>>(a);
}

}  // namespace
}  // namespace dwt
}  // namespace picsong

// X4 over a batch: `levels` launches on `stream`, each checked; no
// synchronisation. `scratch` as in picsong_dwt_forward; `out` is
// (batch, comps, h, w) samples of `type`. Returns the first launch's
// cudaError_t, or 0.
extern "C" int picsong_dwt_reverse(const int32_t* b0, const int32_t* b1,
                                   const int32_t* b2, int batch, int comps,
                                   int h, int w, int levels, int lossy,
                                   int offset, int lo, int hi, int type,
                                   const float* consts, void* scratch,
                                   void* out, void* stream) {
  using namespace picsong::dwt;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int planes = batch * comps;
  char* buf[2] = {static_cast<char*>(scratch),
                  static_cast<char*>(scratch) +
                      static_cast<int64_t>(planes) *
                          (static_cast<int64_t>(h) * w / 4) * 4};
  RevArgs a;
  a.blocks[0] = b0;
  a.blocks[1] = b1;
  a.blocks[2] = b2;
  a.bx = w / kBlockSide;
  a.plane_words = static_cast<int64_t>(h / kBlockSide) * a.bx * kBlockWords;
  a.batch = batch;
  a.comps = comps;
  a.offset = offset;
  a.lo = lo;
  a.hi = hi;
  a.type = type;
  for (int level = levels - 1; level >= 0; --level) {
    a.h = h >> level;
    a.w = w >> level;
    a.deepest = level == levels - 1;
    a.ll_in = a.deepest ? nullptr : buf[level & 1];
    a.out = level ? buf[(level - 1) & 1] : out;
    a.c = level_consts(consts, level);
    if (lossy)
      launch_level<true>(a, level, planes, s);
    else
      launch_level<false>(a, level, planes, s);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}
