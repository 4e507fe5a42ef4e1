// X2 for Hopper (sm_90a): prep, the forward lifting DWT, quantization and
// the codeblock tiling, one launch per level.
//
// Replaces the XLA program of `picsong_tpu/engine/pipeline.py`
// `_prep_gray_impl` / `_prep_rgb_impl` (l.171/176) + `_dwt_tile_impl`
// (l.190): `picsong_tpu/transform/dwt.py:157` `dwt_forward` (levels :139,
// lifting :49/62/107/120) and `core/geometry.py:48` `plane_to_codeblocks`.
// Its plain version is `transform/dwt_cuda.py` `forward_plain`.
//
// A CTA lifts one 64x64 tile of one plane (a component of a frame):
//   - load, with the halo (dwt_common.cuh). At level 0 the load is the
//     prep: the DC shift, and for RGB the RCT (int32, `>> 2`) or the ICT
//     row of the CTA's component, fma(m2, b, fma(m1, g, m0 * r)) rounded
//     once per fma (the oracle's chain, `dwt_cuda.fma_row`); deeper levels
//     load the previous level's LL plane;
//   - vertical lifting on every column of the tile, then horizontal on its
//     own rows (dwt.py:156-168);
//   - store: HL, LH and HH (and at the last level LL) straight into
//     codeblock order, for 9/7 after the horizontal `* K1` of the odd
//     columns and the band's gain * qs, truncated to int32; the
//     intermediate LL, unquantized, into the next level's input plane;
//   - the coefficient maximum: a warp reduction and an atomicMax into the
//     1-element output the entry point zeroes first (replacing
//     `blocks.abs().amax()`).
// Planes smaller than a tile (the deep levels) are masked.
#include "dwt_common.cuh"

namespace picsong {
namespace dwt {
namespace {

struct FwdArgs {
  const void* src[3];       // level 0: the sample planes (gray, or R, G, B)
  int type;                 // their SampleType
  int64_t batch_stride;     // samples between frames of a batch
  int64_t row_stride;       // samples between rows
  const void* ll_in;        // levels > 0: the previous level's LL planes
  void* ll_out;             // this level's LL planes (not at the last level)
  int32_t* blocks;          // (comps, batch, ncb, 64, 64)
  int32_t* top;             // the coefficient maximum
  int64_t plane_words;      // ncb * 4096
  int batch, comps;
  int h, w;                 // this level's plane
  int bx;                   // codeblock columns of the level-0 plane
  int level, last, offset;
  Consts c;
};

// The level-0 value of component `comp` of frame `f` at (gy, gx).
template <bool kLossy>
__device__ __forceinline__ typename Tile<kLossy>::V prep(const FwdArgs& a,
                                                         int comp, int f,
                                                         int gy, int gx) {
  const int64_t i = f * a.batch_stride + gy * a.row_stride + gx;
  if (a.comps == 1) {
    const int32_t s = load_sample(a.src[0], i, a.type) - a.offset;
    if constexpr (kLossy) return static_cast<float>(s);
    else return s;
  }
  const int32_t r = load_sample(a.src[0], i, a.type) - a.offset;
  const int32_t g = load_sample(a.src[1], i, a.type) - a.offset;
  const int32_t b = load_sample(a.src[2], i, a.type) - a.offset;
  if constexpr (kLossy) {
    const float m0 = pick3(a.c.ict[0], a.c.ict[3], a.c.ict[6], comp);
    const float m1 = pick3(a.c.ict[1], a.c.ict[4], a.c.ict[7], comp);
    const float m2 = pick3(a.c.ict[2], a.c.ict[5], a.c.ict[8], comp);
    return __fmaf_rn(static_cast<float>(b), m2,
                     __fmaf_rn(static_cast<float>(g), m1,
                               __fmul_rn(static_cast<float>(r), m0)));
  } else {
    return comp == 0 ? (r + 2 * g + b) >> 2 : (comp == 1 ? b - g : r - g);
  }
}

template <bool kLossy>
__global__ void __launch_bounds__(kThreads)
dwt_forward_kernel(const FwdArgs a) {
  using T = Tile<kLossy>;
  using V = typename T::V;
  constexpr int S = T::kSide, H = T::kHalo, kHalfTile = kTile / 2;
  __shared__ V t[S * S];
  const int p = blockIdx.z;                 // component * batch + frame
  const int comp = p / a.batch, f = p % a.batch;
  const int y0 = blockIdx.y * kTile, x0 = blockIdx.x * kTile;
  const int gy0 = y0 - H, gx0 = x0 - H;
  const int64_t plane = static_cast<int64_t>(a.h) * a.w;
  for (int i = threadIdx.x; i < S * S; i += kThreads) {
    const int gy = gy0 + i / S, gx = gx0 + i % S;
    V v = V(0);
    if (gy >= 0 && gy < a.h && gx >= 0 && gx < a.w)
      v = a.level == 0 ? prep<kLossy>(a, comp, f, gy, gx)
                       : static_cast<const V*>(a.ll_in)[p * plane +
                                                        gy * a.w + gx];
    t[i] = v;
  }
  __syncthreads();
  lift_forward<kLossy, true>(t, 0, S, gy0, a.h, a.c, true);
  lift_forward<kLossy, false>(t, H, H + kTile, gx0, a.w, a.c, false);

  const int h2 = a.h >> 1, w2 = a.w >> 1;
  int32_t top = 0;
#pragma unroll
  for (int band = 0; band < 4; ++band) {     // LL, HL, LH, HH
    const int dy = band >> 1, dx = band & 1;
    for (int i = threadIdx.x; i < kHalfTile * kHalfTile; i += kThreads) {
      const int yy = i / kHalfTile, xx = i % kHalfTile;
      const int y = (y0 >> 1) + yy, x = (x0 >> 1) + xx;
      if (y >= h2 || x >= w2) continue;
      V v = t[(H + 2 * yy + dy) * S + H + 2 * xx + dx];
      if (band == 0 && !a.last) {
        static_cast<V*>(a.ll_out)[p * (plane >> 2) + y * w2 + x] = v;
        continue;
      }
      int32_t q;
      if constexpr (kLossy) {
        if (dx) v = __fmul_rn(v, a.c.k1);
        q = __float2int_rz(__fmul_rn(v, a.c.gain[band]));
      } else {
        q = v;
      }
      a.blocks[p * a.plane_words +
               block_word(y + dy * h2, x + dx * w2, a.bx)] = q;
      top = max(top, abs(q));
    }
  }
  top = __reduce_max_sync(kFullMask, top);
  if ((threadIdx.x & 31) == 0 && top > 0) atomicMax(a.top, top);
}

}  // namespace
}  // namespace dwt
}  // namespace picsong

// X2 over a batch: zeroes `top`, then `levels` launches on `stream`, each
// checked; no synchronisation. `scratch` holds the intermediate LL planes:
// two regions used in turn, batch * comps planes of a quarter and of a
// sixteenth of the plane. Returns the first cudaError_t, or 0.
extern "C" int picsong_dwt_forward(const void* s0, const void* s1,
                                   const void* s2, int type,
                                   long long batch_stride,
                                   long long row_stride, int batch, int comps,
                                   int h, int w, int levels, int lossy,
                                   int offset, const float* consts,
                                   void* scratch, int32_t* blocks,
                                   int32_t* top, void* stream) {
  using namespace picsong::dwt;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int64_t planes = static_cast<int64_t>(batch) * comps;
  char* buf[2] = {static_cast<char*>(scratch),
                  static_cast<char*>(scratch) +
                      planes * (static_cast<int64_t>(h) * w / 4) * 4};
  FwdArgs a;
  a.src[0] = s0;
  a.src[1] = s1;
  a.src[2] = s2;
  a.type = type;
  a.batch_stride = batch_stride;
  a.row_stride = row_stride;
  a.blocks = blocks;
  a.top = top;
  a.bx = w / kBlockSide;
  a.plane_words = static_cast<int64_t>(h / kBlockSide) * a.bx * kBlockWords;
  a.batch = batch;
  a.comps = comps;
  a.offset = offset;
  const cudaError_t zeroed = cudaMemsetAsync(top, 0, sizeof(int32_t), s);
  if (zeroed != cudaSuccess) return static_cast<int>(zeroed);
  for (int level = 0; level < levels; ++level) {
    a.h = h >> level;
    a.w = w >> level;
    a.level = level;
    a.last = level == levels - 1;
    a.ll_in = level ? buf[(level - 1) & 1] : nullptr;
    a.ll_out = a.last ? nullptr : buf[level & 1];
    a.c = level_consts(consts, level);
    const dim3 grid((a.w + kTile - 1) / kTile, (a.h + kTile - 1) / kTile,
                    static_cast<unsigned>(planes));
    if (lossy)
      dwt_forward_kernel<true><<<grid, kThreads, 0, s>>>(a);
    else
      dwt_forward_kernel<false><<<grid, kThreads, 0, s>>>(a);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}
