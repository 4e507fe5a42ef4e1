// X2 for Hopper (sm_90a): prep, the forward lifting DWT, quantization and
// the codeblock tiling, one launch per level.
//
// Replaces the XLA program of `picsong_tpu/engine/pipeline.py`
// `_prep_gray_impl` / `_prep_rgb_impl` (l.171/176) + `_dwt_tile_impl`
// (l.190): `picsong_tpu/transform/dwt.py:157` `dwt_forward` (levels :139,
// lifting :49/62/107/120) and `core/geometry.py:48` `plane_to_codeblocks`.
// Its plain version is `transform/dwt_cuda.py` `forward_plain`.
//
// A CTA of 288 threads lifts one 64x64 tile of one plane (a component of a
// frame) with three barriers:
//   - load: 16-byte chunks of the tile's rows, aligned, with the aligned
//     chunks either side for the halo columns (16 8-bit, 8 16-bit or 4
//     int32/float samples a chunk), into A, the tile with 4 rows and
//     columns of halo in shared memory, as float4/int4 groups; a thread
//     issues all its loads before it converts any. At level 0 the load is
//     the prep: the DC shift, and for RGB the RCT (int32, `>> 2`) or the
//     ICT row of the CTA's component, fma(m2, b, fma(m1, g, m0 * r))
//     rounded once per fma (the oracle's chain, `dwt_cuda.fma_row`);
//     deeper levels load the previous level's LL plane. Where a sample
//     plane's base or strides are not multiples of 16 bytes (an offset
//     view), or a deep LL plane's width not a multiple of 4, the kVec =
//     false variant reads the same chunks a sample at a time; barrier;
//   - vertical: a thread owns a strip of 16 rows (plus the halo) of one
//     column, lifts it in registers (every step of the level, unrolled)
//     and writes its 16 rows to B; barrier;
//   - horizontal: a thread owns 16 columns (plus the halo) of one row of B,
//     lifts them in registers and stages its 8 low and 8 high coefficients
//     over A, for 9/7 after the `* K1` of the odd columns and the band's
//     gain * qs, truncated to int32 (the intermediate LL unquantized);
//     barrier;
//   - copy-out: each band row of the tile's 32 coefficients goes out as 8
//     int4s, 128 contiguous bytes of a codeblock row (or of the next
//     level's LL row). Storing each thread's 16 bytes straight from the
//     horizontal pass (32 rows a warp instruction) made level 0 3x slower
//     than this;
//   - the coefficient maximum: a warp reduction and an atomicMax into the
//     1-element output the entry point zeroes first (replacing
//     `blocks.abs().amax()`).
// A's row pitch (76 words) keeps its float4 rows aligned; B's (73 words,
// odd) lets a warp's 32 row strips read 32 banks. Planes smaller than a
// tile (the deep levels) are masked; a band not a multiple of 4 wide is
// stored a coefficient at a time. What bounds X2 on an H100 is the bytes
// (dwt_common.cuh); this design reaches 20-30% of that bound: a CTA's
// phases run one after another, and a deep level is a launch and one
// CTA's chain.
//
// The kShard variants are the shard mode (dwt_common.cuh,
// `picsong_dwt_forward_shard`): the same phases on one shard's rows of a
// taller plane, from its rows and halo (samples with the prep at level
// 0, else int32 / float values), the four bands stored as row-major band
// rows instead of codeblocks.
#include "dwt_common.cuh"

namespace picsong {
namespace dwt {
namespace {

constexpr int kFwdThreads = 288;          // 4 vertical strips of 72 columns
constexpr int kPad = 4;                   // A and B start 4 rows / columns
constexpr int kSideA = kTile + 2 * kPad;  //   before the tile
constexpr int kPitchA = kSideA + 4;
constexpr int kPitchB = kSideA + 1;
static_assert(kStrips * kSideA <= kFwdThreads, "a vertical strip a thread");
static_assert(kStrips * kTile <= kFwdThreads, "a horizontal strip a thread");
// the staged coefficients of a tile, a band's 32 x 32 in rows of 36 words,
// band after band 1160 words apart: the 16-byte stores of a quarter-warp
// (4 band rows, two bands) fall on 8 distinct groups of 4 banks
constexpr int kStageRow = kTile / 2 + 4;
constexpr int kStageBand = kTile / 2 * kStageRow + 8;
static_assert(4 * kStageBand <= kSideA * kPitchA, "the staging fits in A");

struct FwdArgs {
  const void* src[3];       // level 0 (shard mode: every level): the input
                            // planes (gray, or R, G, B; or the components)
  int type;                 // their SampleType
  int64_t batch_stride;     // samples between frames of a batch
  int64_t row_stride;       // samples between rows
  const void* ll_in;        // levels > 0: the previous level's LL planes
  void* ll_out;             // this level's LL planes (not at the last level)
  int32_t* blocks;          // (comps, batch, ncb, 64, 64); shard mode: the
                            // band rows (4, comps, (r1 - r0) / 2, w / 2)
  int32_t* top;             // the coefficient maximum
  int64_t plane_words;      // ncb * 4096
  int batch, comps;
  int h, w;                 // this level's plane
  int bx;                   // codeblock columns of the level-0 plane
  int last, offset;
  Consts c;
  // shard mode (after the whole-plane fields, which keep their offsets)
  int in0, in1;             // the plane rows `src` holds
  int r0, r1;               // the plane rows to lift and store
};

// The plane rows a launch stores: [r0, r1) in shard mode, else all.
template <bool kShard>
__device__ __forceinline__ int row_end(const FwdArgs& a) {
  return kShard ? a.r1 : a.h;
}

// Whether plane row gy is in the input: the buffer's rows in shard mode,
// else the plane's.
template <bool kShard>
__device__ __forceinline__ bool row_in(const FwdArgs& a, int gy) {
  return kShard ? gy >= a.in0 && gy < a.in1 : gy >= 0 && gy < a.h;
}

// Shard mode: the first byte of plane row gy of input plane i (a sample
// plane, or kBytes 4 a value plane).
template <int kBytes>
__device__ __forceinline__ const char* shard_row(const FwdArgs& a, int i,
                                                 int gy) {
  return static_cast<const char*>(pick_ptr(a.src, i)) +
         static_cast<int64_t>(gy - a.in0) * a.row_stride * kBytes;
}

template <class V>
__device__ __forceinline__ V from_bits(uint32_t u) {
  if constexpr (std::is_same<V, float>::value) return __uint_as_float(u);
  else return static_cast<int32_t>(u);
}

__device__ __forceinline__ void store4(float* p, const float (&v)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}

__device__ __forceinline__ void store4(int32_t* p, const int32_t (&v)[4]) {
  *reinterpret_cast<int4*>(p) = make_int4(v[0], v[1], v[2], v[3]);
}

// Sample j of a 16-byte chunk of kBytes-byte samples, sign-extended where
// `sx` is the type's sign bit (0 for an unsigned type).
template <int kBytes>
__device__ __forceinline__ int32_t unpack(const uint4& u, int j,
                                          uint32_t sx) {
  const uint32_t words[4] = {u.x, u.y, u.z, u.w};
  const uint32_t word = words[(j * kBytes) >> 2];
  const uint32_t raw =
      kBytes == 1 ? (word >> (8 * (j & 3))) & 0xffu
                  : (word >> (16 * (j & 1))) & 0xffffu;
  return static_cast<int32_t>(raw ^ sx) - static_cast<int32_t>(sx);
}

// The level-0 value of component `comp` from its DC-shifted samples.
template <bool kLossy>
__device__ __forceinline__ typename Tile<kLossy>::V color(const FwdArgs& a,
                                                          int comp,
                                                          int32_t r,
                                                          int32_t g,
                                                          int32_t b) {
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

// The 16 bytes at plane row gy, columns xs.., of sample plane c of frame
// f (level 0, kBytes 1 or 2) or of LL plane p (kBytes 4); 0 where the
// chunk lies outside the plane (a vector chunk lies in it whole or not at
// all) or, in shard mode, outside the buffer (batch 1: plane p is
// component p).
template <int kBytes, bool kShard, class V>
__device__ __forceinline__ uint4 fetch_chunk(const FwdArgs& a, int c, int f,
                                             int p, int gy, int xs) {
  if constexpr (kShard) {
    if (!row_in<true>(a, gy) || xs < 0 || xs >= a.w)
      return make_uint4(0, 0, 0, 0);
    return __ldg(reinterpret_cast<const uint4*>(
        shard_row<kBytes>(a, kBytes == 4 ? p : c, gy) + xs * kBytes));
  }
  if (gy < 0 || gy >= a.h || xs < 0 || xs >= a.w)
    return make_uint4(0, 0, 0, 0);
  if constexpr (kBytes == 4)
    return __ldg(reinterpret_cast<const uint4*>(
        static_cast<const V*>(a.ll_in) +
        (static_cast<int64_t>(p) * a.h + gy) * a.w + xs));
  else
    return __ldg(reinterpret_cast<const uint4*>(
        static_cast<const char*>(a.src[c]) +
        (f * a.batch_stride + gy * a.row_stride + xs) * kBytes));
}

// The chunk of 16 / kBytes values at plane row gy, columns xs.., into A's
// row `row`, its value j at A's column first + j: the groups of 4 inside
// A's columns, each computed only where it is stored. Samples after the
// prep at level 0 (kBytes 1 or 2: component `comp` of frame `f`), the
// previous level's LL values (kBytes 4: plane p); 0 outside the plane.
// With kVec the chunk's 16 bytes of each plane are `u` (fetch_chunk), else
// the values are read one at a time.
template <bool kLossy, int kBytes, bool kVec, bool kShard>
__device__ __forceinline__ void store_chunk(
    const FwdArgs& a, int comp, int f, int p, int gy, int xs, int first,
    const uint4 (&u)[3], typename Tile<kLossy>::V* row) {
  using V = typename Tile<kLossy>::V;
  constexpr int kW = 16 / kBytes;
  const bool gy_in = row_in<kShard>(a, gy);
  const bool chunk_in = gy_in && xs >= 0 && xs < a.w;
  if constexpr (kBytes == 4) {
    if (first < 0 || first >= kSideA) return;
    V g[4];
    if constexpr (kVec) {
      g[0] = from_bits<V>(u[0].x);
      g[1] = from_bits<V>(u[0].y);
      g[2] = from_bits<V>(u[0].z);
      g[3] = from_bits<V>(u[0].w);
    } else {
      const V* src =
          kShard ? reinterpret_cast<const V*>(shard_row<4>(a, p, gy))
                 : static_cast<const V*>(a.ll_in) +
                       (static_cast<int64_t>(p) * a.h + gy) * a.w;
#pragma unroll
      for (int j = 0; j < kW; ++j)
        g[j] = gy_in && xs + j >= 0 && xs + j < a.w ? src[xs + j] : V(0);
    }
    store4(row + first, g);
  } else {
    const int64_t i0 =
        kShard ? static_cast<int64_t>(gy - a.in0) * a.row_stride + xs
               : f * a.batch_stride + gy * a.row_stride + xs;
    const int planes = a.comps == 1 ? 1 : 3;
    const uint32_t sx = (a.type & 1) ? (kBytes == 1 ? 0x80u : 0x8000u) : 0u;
#pragma unroll
    for (int m = 0; m < kW / 4; ++m) {
      const int col = first + 4 * m;
      if (col < 0 || col >= kSideA) continue;
      V g[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int j = 4 * m + e;
        const bool in = kVec ? chunk_in
                             : gy_in && xs + j >= 0 && xs + j < a.w;
        int32_t s3[3] = {0, 0, 0};
#pragma unroll
        for (int c = 0; c < 3; ++c)
          if (c < planes)
            s3[c] = (kVec ? unpack<kBytes>(u[c], j, sx)
                          : (in ? load_sample(a.src[c], i0 + j, a.type)
                                : 0)) -
                    a.offset;
        V v;
        if (planes == 1) {
          if constexpr (kLossy) v = static_cast<float>(s3[0]);
          else v = s3[0];
        } else {
          v = color<kLossy>(a, comp, s3[0], s3[1], s3[2]);
        }
        g[e] = in ? v : V(0);
      }
      store4(row + col, g);
    }
  }
}

// The words X2 stages for band `band` from four of its coefficients: at
// the intermediate LL the values as they are (their bits), else quantized
// (9/7: the odd columns' `* K1`, the band's gain * qs, truncated to
// int32), the magnitudes of the first `n` into `top`.
template <bool kLossy>
__device__ __forceinline__ uint4 stage_words(
    const FwdArgs& a, int band, int dx, int n,
    const typename Tile<kLossy>::V (&v)[4], int32_t& top) {
  uint32_t w[4];
  if (band == 0 && !a.last) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if constexpr (kLossy) w[e] = __float_as_uint(v[e]);
      else w[e] = static_cast<uint32_t>(v[e]);
    }
  } else {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      int32_t q;
      if constexpr (kLossy) {
        const float t = dx ? __fmul_rn(v[e], a.c.k1) : v[e];
        q = __float2int_rz(__fmul_rn(t, gain_of(a.c, band)));
      } else {
        q = v[e];
      }
      if (e < n) top = max(top, abs(q));
      w[e] = static_cast<uint32_t>(q);
    }
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// Four staged words of band `band` at band row y, band columns x.. of
// plane p into their place: codeblock order, or at the intermediate LL
// the next level's input plane; in shard mode the band's rows, row-major
// from band row r0 / 2; an int4 when `vec`, else those inside the band
// one at a time.
template <bool kShard>
__device__ __forceinline__ void put_words(const FwdArgs& a, int p, int band,
                                          int y, int x, bool vec,
                                          const uint4& u) {
  const int h2 = a.h >> 1, w2 = a.w >> 1;
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
  if constexpr (kShard) {
    const int rows = (a.r1 - a.r0) >> 1;
    uint32_t* out = reinterpret_cast<uint32_t*>(a.blocks) +
                    ((static_cast<int64_t>(band) * a.comps + p) * rows + y -
                     (a.r0 >> 1)) * w2 + x;
    if (vec) {
      *reinterpret_cast<uint4*>(out) = u;
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (x + e < w2) out[e] = w[e];
    }
    return;
  }
  if (band == 0 && !a.last) {
    uint32_t* out = static_cast<uint32_t*>(a.ll_out) +
                    (static_cast<int64_t>(p) * h2 + y) * w2 + x;
    if (vec) {
      *reinterpret_cast<uint4*>(out) = u;
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (x + e < w2) out[e] = w[e];
    }
    return;
  }
  const int dy = band >> 1, dx = band & 1;
  int32_t* blocks = a.blocks + p * a.plane_words;
  if (vec) {
    *reinterpret_cast<uint4*>(
        blocks + block_word(y + dy * h2, x + dx * w2, a.bx)) = u;
  } else {
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if (x + e < w2)
        blocks[block_word(y + dy * h2, x + e + dx * w2, a.bx)] =
            static_cast<int32_t>(w[e]);
  }
}

template <bool kLossy, int kBytes, bool kVec, bool kShard>
__global__ void __launch_bounds__(kFwdThreads, 4)
dwt_forward_kernel(const FwdArgs a) {
  using V = typename Tile<kLossy>::V;
  constexpr int H = Tile<kLossy>::kHalo;
  constexpr int N = kStrip + 2 * H;            // a strip with its halo
  constexpr int kW = 16 / kBytes;              // values a chunk
  constexpr int kLead = kW > kPad ? kW : kPad; // the chunk before the tile
  constexpr int kChunks = (kTile + 2 * kLead) / kW;
  constexpr int kRows = kTile + 2 * H;         // A's rows and columns used
  __shared__ __align__(16) V A[kSideA * kPitchA];
  __shared__ V B[kTile * kPitchB];
  uint32_t* S = reinterpret_cast<uint32_t*>(A);  // the staging, over A
  const int p = blockIdx.z;                    // component * batch + frame
  const int comp = p / a.batch, f = p - comp * a.batch;
  // shard mode: the tiles start at the shard's first row r0 (even)
  const int y0 = kShard ? a.r0 + blockIdx.y * kTile : blockIdx.y * kTile;
  const int x0 = blockIdx.x * kTile;
  const int t = threadIdx.x;

  // load: item `it` is chunk q of plane row y0 - H + row, A's row
  // kPad - H + row; a thread issues all its vector loads before it
  // converts any
  constexpr int kItems = kRows * kChunks;
  constexpr int kIters = (kItems + kFwdThreads - 1) / kFwdThreads;
  uint4 u[kIters][3] = {};
  if constexpr (kVec) {
#pragma unroll
    for (int i = 0; i < kIters; ++i) {
      const int it = t + i * kFwdThreads;
      const int row = it / kChunks, q = it - row * kChunks;
#pragma unroll
      for (int c = 0; c < (kBytes == 4 ? 1 : 3); ++c)
        if (it < kItems && c < a.comps)
          u[i][c] = fetch_chunk<kBytes, kShard, V>(a, c, f, p, y0 - H + row,
                                                   x0 - kLead + kW * q);
    }
  }
#pragma unroll
  for (int i = 0; i < kIters; ++i) {
    const int it = t + i * kFwdThreads;
    const int row = it / kChunks, q = it - row * kChunks;
    if (it < kItems)
      store_chunk<kLossy, kBytes, kVec, kShard>(
          a, comp, f, p, y0 - H + row, x0 - kLead + kW * q,
          kPad - kLead + kW * q, u[i], &A[(kPad - H + row) * kPitchA]);
  }
  __syncthreads();

  // vertical: strip s of column `col`, plane rows g0 .. g0 + N
  constexpr int kCols = kTile + 2 * H;
  if (t < kStrips * kCols) {
    const int s = t / kCols;
    const int col = kPad - H + t - s * kCols;
    const int g0 = y0 + kStrip * s - H;
    if (g0 + H < row_end<kShard>(a)) {
      V v[N];
#pragma unroll
      for (int i = 0; i < N; ++i)
        v[i] = A[(kPad - H + kStrip * s + i) * kPitchA + col];
      if (g0 <= 0 || g0 + N >= a.h)
        lift_forward_regs<kLossy, true, true>(v, -g0, a.h - 1 - g0, a.c);
      else
        lift_forward_regs<kLossy, false, true>(v, 0, 0, a.c);
#pragma unroll
      for (int i = 0; i < kStrip; ++i)
        B[(kStrip * s + i) * kPitchB + col] = v[H + i];
    }
  }
  __syncthreads();

  // horizontal: strip k of tile row r, plane columns g0 .. g0 + N; then
  // the 8 low and 8 high coefficients of the strip into their bands
  int32_t top = 0;
  if (t < kStrips * kTile) {
    const int r = t % kTile, k = t / kTile;
    const int g0 = x0 + kStrip * k - H;
    if (y0 + r < row_end<kShard>(a) && g0 + H < a.w) {
      V v[N];
#pragma unroll
      for (int i = 0; i < N; ++i)
        v[i] = B[r * kPitchB + kPad - H + kStrip * k + i];
      if (g0 <= 0 || g0 + N >= a.w)
        lift_forward_regs<kLossy, true, false>(v, -g0, a.w - 1 - g0, a.c);
      else
        lift_forward_regs<kLossy, false, false>(v, 0, 0, a.c);
      const int dy = r & 1, yl = r >> 1;
      const int xl = kStrip / 2 * k;           // the strip's band column
      const int n = (a.w >> 1) - (x0 >> 1) - xl;  // of them in the band
#pragma unroll
      for (int half = 0; half < 2; ++half) {
#pragma unroll
        for (int dx = 0; dx < 2; ++dx) {
          const V c4[4] = {v[H + 8 * half + dx], v[H + 8 * half + 2 + dx],
                           v[H + 8 * half + 4 + dx],
                           v[H + 8 * half + 6 + dx]};
          const int band = 2 * dy + dx;
          *reinterpret_cast<uint4*>(
              &S[band * kStageBand + yl * kStageRow + xl + 4 * half]) =
              stage_words<kLossy>(a, band, dx, n - 4 * half, c4, top);
        }
      }
    }
  }
  __syncthreads();

  // the copy-out: a band row's 32 words of the tile as 8 int4s, 128
  // contiguous bytes of a codeblock row (or of an LL row); a thread takes
  // one int4 of each band
  if (t < kTile / 2 * 8) {
    const int yl = t >> 3, c4 = t & 7;
    const int y = (y0 >> 1) + yl, x = (x0 >> 1) + 4 * c4;
    const int w2 = a.w >> 1;
    if (y < (row_end<kShard>(a) >> 1) && x < w2) {
#pragma unroll
      for (int band = 0; band < 4; ++band)
        put_words<kShard>(a, p, band, y, x, (w2 & 3) == 0,
                  *reinterpret_cast<const uint4*>(
                      &S[band * kStageBand + yl * kStageRow + 4 * c4]));
    }
  }
  top = __reduce_max_sync(kFullMask, top);
  if ((t & 31) == 0 && top > 0) atomicMax(a.top, top);
}

// One level: the variant of the level's input (kBytes of a value, vector
// or scalar loads) and of its rows (kShard).
template <bool kLossy, bool kShard = false>
void launch_level(const FwdArgs& a, int bytes, bool vec, dim3 grid,
                  cudaStream_t s) {
  const auto go = [&](void (*kernel)(FwdArgs)) {
    kernel<<<grid, kFwdThreads, 0, s>>>(a);
  };
  if (bytes == 1)
    go(vec ? dwt_forward_kernel<kLossy, 1, true, kShard>
           : dwt_forward_kernel<kLossy, 1, false, kShard>);
  else if (bytes == 2)
    go(vec ? dwt_forward_kernel<kLossy, 2, true, kShard>
           : dwt_forward_kernel<kLossy, 2, false, kShard>);
  else
    go(vec ? dwt_forward_kernel<kLossy, 4, true, kShard>
           : dwt_forward_kernel<kLossy, 4, false, kShard>);
}

}  // namespace
}  // namespace dwt
}  // namespace picsong

// X2 over a batch: zeroes `top`, then `levels` launches on `stream`, each
// checked; no synchronisation. `vec` says the sample planes' bases and
// strides are multiples of 16 bytes (the wrapper's check): level 0 then
// loads 16-byte vectors, else a sample at a time. `scratch` holds the
// intermediate LL planes: two regions used in turn, batch * comps planes
// of a quarter and of a sixteenth of the plane. Returns the first
// cudaError_t, or 0.
extern "C" int picsong_dwt_forward(const void* s0, const void* s1,
                                   const void* s2, int type, int vec,
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
    a.last = level == levels - 1;
    a.ll_in = level ? buf[(level - 1) & 1] : nullptr;
    a.ll_out = a.last ? nullptr : buf[level & 1];
    a.c = level_consts(consts, level);
    const dim3 grid((a.w + kTile - 1) / kTile, (a.h + kTile - 1) / kTile,
                    static_cast<unsigned>(planes));
    const int bytes = level ? 4 : (type == kU8 || type == kI8 ? 1 : 2);
    const bool v = level ? (a.w & 3) == 0 : vec != 0;
    if (lossy)
      launch_level<true>(a, bytes, v, grid, s);
    else
      launch_level<false>(a, bytes, v, grid, s);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}

// X2's shard mode: one launch of level `level` of one image's `comps`
// planes (h x w, the level's plane) on `stream`, lifting and storing the
// plane rows [r0, r1) (even) from input planes that hold the rows [in0,
// in1) (the shard's rows and its halo, clipped at the plane), `row_stride`
// samples apart: sample planes of `type` with the prep (level 0), or
// (type kValues) int32 / float values. Writes the band rows (4, comps,
// (r1 - r0) / 2, w / 2) of LL, HL, LH, HH to `bands` (an intermediate LL
// as its values' bits, the rest quantized) and their maximum magnitude
// into `top` by atomicMax (not zeroed here). `vec`: the wrapper's check
// that every plane's base and row stride are multiples of 16 bytes.
// Returns the launch's cudaError_t, or 0.
extern "C" int picsong_dwt_forward_shard(
    const void* s0, const void* s1, const void* s2, int type, int vec,
    long long row_stride, int comps, int h, int w, int level, int levels,
    int lossy, int offset, int in0, int in1, int r0, int r1,
    const float* consts, int32_t* bands, int32_t* top, void* stream) {
  using namespace picsong::dwt;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  FwdArgs a = {};
  a.src[0] = s0;
  a.src[1] = s1;
  a.src[2] = s2;
  a.type = type;
  a.row_stride = row_stride;
  a.blocks = bands;
  a.top = top;
  a.batch = 1;
  a.comps = comps;
  a.h = h;
  a.w = w;
  a.last = level == levels - 1;
  a.offset = offset;
  a.in0 = in0;
  a.in1 = in1;
  a.r0 = r0;
  a.r1 = r1;
  a.c = level_consts(consts, level);
  const dim3 grid((w + kTile - 1) / kTile, (r1 - r0 + kTile - 1) / kTile,
                  static_cast<unsigned>(comps));
  const int bytes =
      type == kValues ? 4 : (type == kU8 || type == kI8 ? 1 : 2);
  if (lossy)
    launch_level<true, true>(a, bytes, vec != 0, grid, s);
  else
    launch_level<false, true>(a, bytes, vec != 0, grid, s);
  return static_cast<int>(cudaGetLastError());
}
