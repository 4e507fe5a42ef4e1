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
// A CTA of 288 threads rebuilds one 64x64 tile of a level's plane, the
// mirror of X2 (dwt_forward.cu), with two barriers a component and one
// before the copy-out:
//   - load: the tile's four bands, 32x32 coefficients each plus the halo
//     (1 band position a side for 5/3, 2 for 9/7), in 16-byte chunks of
//     their rows: 128 contiguous bytes of a codeblock row, or of the
//     deeper level's LL plane above the deepest level, and the aligned
//     chunk either side for the halo columns. A thread takes one chunk
//     column of one band in every 14th row (`Loader`), so it converts its
//     words without a branch, and issues all its loads before it converts
//     any. 9/7 dequantizes each codeblock value once, at the midpoint:
//     (|q| + 0.5) with q's sign, divided by the gain and then by qs, 0
//     kept 0 (dwt.py:230-239; the deepest LL with the LL gain, an
//     intermediate LL not at all), then divides the odd columns' bands
//     (HL, HH) by K1, the horizontal synthesis's first step; every
//     division goes through `div_rn`. The values go to S in band layout:
//     row r of the tile with its halo (plane row y0 - H + r, band row of
//     its parity) holds the L band's 36 staged columns, then the H band's.
//     Where a band is not a multiple of 4 words wide, or the codeblocks'
//     base is not 16-byte aligned, the kVec = false variant reads the same
//     chunks a word at a time; barrier;
//   - horizontal: a thread owns 16 columns (plus the halo) of one row of
//     the tile with its halo, builds its strip in plane order (even
//     columns from the L band, odd from the H band), lifts it in registers
//     (every step of the level, unrolled) and writes its 16 columns to B;
//     barrier;
//   - vertical: a thread owns 16 rows (plus the halo) of one tile column,
//     lifts them in registers, the 9/7 odd rows' `/ K1` first, and writes
//     its 16 rows to the component's tile T (over S for the last
//     component);
//   - copy-out, after a barrier: above level 0 each tile row of the next
//     level's LL plane goes out as 16-byte chunks (a value at a time where
//     the plane is not a multiple of 4 wide); at level 0 the finish, from
//     the tiles of every component of the CTA's frame (RGB: the CTA runs
//     load, horizontal and vertical for each component in turn and keeps
//     each tile in shared memory, because the inverse colour transform
//     mixes them):
//       gray lossless: x + offset;   gray lossy: rint((x + offset) + 0.01f);
//       RGB lossless (RCT): g = y - ((u + v) >> 2), r = v + g, b = u + g;
//       RGB lossy (ICT): rint(fma(m2, cr, fma(m1, cb, m0 * y)) + 0.01f) as
//       int32 (the oracle's chain, `dwt_cuda.fma_row`);
//     then (RGB: + offset) the clamp, and the samples packed 16 (8-bit) or
//     8 (16-bit) to a 16-byte store of a sample row.
// S's row pitch (73 words, odd) and B's (65) let a warp's 32 row strips
// read and write 32 banks; T's (68) keeps its rows' 16-byte groups
// aligned. Planes smaller than a tile (the deep levels) are masked. What
// bounds X4 on an H100 is the bytes (dwt_common.cuh); this design's
// device time reaches 24-45% of that bound for 5/3 and 12-24% for 9/7,
// whose dequantization and float lifting take about twice the time
// (PERF.md).
//
// The kShard variants are the shard mode (dwt_common.cuh,
// `picsong_dwt_reverse_shard`): the same phases on one shard's rows of a
// taller plane, the four bands read from row-major band rows (the
// shard's and its halo) instead of codeblocks and a deeper LL plane.
#include <atomic>

#include "dwt_common.cuh"

namespace picsong {
namespace dwt {
namespace {

constexpr int kRevThreads = 288;          // 4 horizontal strips of 72 rows
constexpr int kWords = 4;                 // int32 / float words a chunk
constexpr int kLead = 4;                  // the chunk before a tile's band
constexpr int kLoadChunks = (kTile / 2 + 2 * kLead) / kWords;
// the load: thread t < kLoadThreads takes chunk t % kLoadChunks of band
// (r & 1, t / kLoadChunks % 2)'s row in tile rows r = t / kLoadLanes +
// kLoadRows i, rows of one parity: one band, one chunk column a thread
constexpr int kLoadLanes = 2 * kLoadChunks;
constexpr int kLoadRows = kRevThreads / kLoadLanes;
constexpr int kLoadThreads = kLoadRows * kLoadLanes;
static_assert(kLoadRows % 2 == 0, "a thread's rows share their parity");
// S: a tile row's staged columns of a band, band column x0 / 2 - 2 + j at
// j (the tile's 32 and 2 a side), the L band's then the H band's
constexpr int kStageCols = kTile / 2 + 4;
constexpr int kPitchS = 2 * kStageCols + 1;
constexpr int kPitchB = kTile + 1;
constexpr int kPitchT = kTile + 4;
static_assert(kStrips * (kTile + 8) <= kRevThreads, "a row strip a thread");
static_assert(kStrips * kTile <= kRevThreads, "a column strip a thread");
static_assert(kTile * kPitchT <= (kTile + 4) * kPitchS, "T fits over S");

struct RevArgs {
  const int32_t* blocks[3];  // per component (batch, ncb, 64, 64)
  const void* ll_in;         // above the deepest level: its LL planes
  void* out;                 // this level's planes, or (level 0) samples;
                             // shard mode: (comps, r1 - r0, w)
  int64_t plane_words;       // ncb * 4096
  int batch, comps;
  int h, w;                  // this level's plane
  int bx;                    // codeblock columns of the level-0 plane
  int deepest, offset, lo, hi, type;
  Consts c;
  // shard mode (after the whole-plane fields, which keep their offsets)
  const void* band[4];       // the LL, HL, LH, HH band rows, (comps, in1 -
                             // in0, w / 2) each
  int in0, in1;              // the band rows `band` holds
  int r0, r1;                // the plane rows to store
};

// The plane rows a launch stores: [r0, r1) in shard mode, else all.
template <bool kShard>
__device__ __forceinline__ int row_end(const RevArgs& a) {
  return kShard ? a.r1 : a.h;
}

// The shared memory of a variant, in bytes: S and B, and the tiles of
// every component but the last (whose tile lies over S).
template <bool kLossy, int kComps>
constexpr int smem_bytes() {
  constexpr int rows = kTile + 2 * Tile<kLossy>::kHalo;
  return 4 * (rows * (kPitchS + kPitchB) + (kComps - 1) * kTile * kPitchT);
}

// What a thread of the load reads and how it converts it: chunk q of
// band (dy, dx), band columns x .. x + 3, at any band row y -- the deeper
// level's LL plane p for band 0 above the deepest level, else the frame's
// codeblocks; in shard mode the band's rows of component p -- and the
// staged values: 5/3 the words as they are; 9/7 an
// intermediate LL's float bits, else each codeblock value q dequantized
// at the midpoint, (|q| + 0.5) with q's sign divided by the band's gain,
// then by qs, then (the H band) by K1, 0 kept 0. Per-thread constants, no
// branch a word: a warp's lanes hold different bands.
template <bool kLossy, bool kShard>
struct Loader {
  const uint32_t* base;
  bool ll;
  int dy, dx, q, x;
  float gain, rgain, kd, rkd;

  __device__ __forceinline__ Loader(const RevArgs& a, const int32_t* blocks,
                                    int p, int t, int x0) {
    const int lane = t % kLoadLanes;
    dy = (t / kLoadLanes) & 1;
    dx = lane / kLoadChunks;
    q = lane % kLoadChunks;
    x = (x0 >> 1) - kLead + kWords * q;
    ll = !(dy | dx) && !a.deepest;
    if constexpr (kShard) {
      base = static_cast<const uint32_t*>(pick_ptr(a.band, 2 * dy + dx)) +
             static_cast<int64_t>(p) * (a.in1 - a.in0) * (a.w >> 1);
    } else {
      base = ll ? static_cast<const uint32_t*>(a.ll_in) +
                      static_cast<int64_t>(p) * (a.h >> 1) * (a.w >> 1)
                : reinterpret_cast<const uint32_t*>(blocks);
    }
    const int band = 2 * dy + dx;
    gain = gain_of(a.c, band);
    rgain = rgain_of(a.c, band);
    kd = dx ? a.c.k1 : 1.0f;             // x / 1 is x: no select a word
    rkd = dx ? a.c.rk1 : 1.0f;
  }

  // The word at band row y, band column x + e.
  __device__ __forceinline__ const uint32_t* at(const RevArgs& a, int y,
                                                int e) const {
    const int h2 = a.h >> 1, w2 = a.w >> 1;
    if constexpr (kShard)
      return base + static_cast<int64_t>(y - a.in0) * w2 + x + e;
    const int64_t in_ll = static_cast<int64_t>(y) * w2 + x + e;
    const int64_t in_blocks = block_word(y + dy * h2, x + e + dx * w2, a.bx);
    return base + (ll ? in_ll : in_blocks);
  }

  __device__ __forceinline__ typename Tile<kLossy>::V value(
      const RevArgs& a, uint32_t w) const {
    if constexpr (!kLossy) {
      return static_cast<int32_t>(w);
    } else {
      const int32_t v = static_cast<int32_t>(w);
      const float mag = __fadd_rn(static_cast<float>(abs(v)), a.c.recon);
      const float d = div_rn(div_rn(div_rn(v < 0 ? -mag : mag, gain, rgain),
                                    a.c.qs, a.c.rqs),
                             kd, rkd);
      return ll ? __uint_as_float(w) : (v == 0 ? 0.0f : d);
    }
  }
};

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

// Level 0's copy-out: the finish of frame f's tile from the components'
// tiles (`tile(k)`), each 16 bytes of a sample row (16 / kBytes samples)
// packed and stored at once.
template <bool kLossy, int kComps, int kBytes, bool kShard, class Tiles>
__device__ __forceinline__ void put_samples(const RevArgs& a, Tiles tile,
                                            int f, int y0, int x0) {
  using V = typename Tile<kLossy>::V;
  constexpr int kW = 16 / kBytes;             // samples a chunk
  constexpr int kChunks = kTile / kW;         // chunks a tile row
  constexpr uint32_t kMask = kBytes == 1 ? 0xffu : 0xffffu;
  for (int it = threadIdx.x; it < kTile * kChunks; it += kRevThreads) {
    const int r = it / kChunks, q = it - r * kChunks;
    const int y = y0 + r, x = x0 + kW * q;
    if (y >= row_end<kShard>(a) || x >= a.w) continue;
    uint32_t w[kComps][4] = {};
#pragma unroll
    for (int m = 0; m < kW / 4; ++m) {
      V g[kComps][4];
#pragma unroll
      for (int k = 0; k < kComps; ++k) {
        const uint4 u = *reinterpret_cast<const uint4*>(
            tile(k) + r * kPitchT + kW * q + 4 * m);
        const uint32_t b[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          if constexpr (kLossy) g[k][e] = __uint_as_float(b[e]);
          else g[k][e] = static_cast<int32_t>(b[e]);
        }
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        V v[kComps];
        int32_t s[kComps];
#pragma unroll
        for (int k = 0; k < kComps; ++k) v[k] = g[k][e];
        finish<kLossy, kComps>(a, v, s);
        const int j = 4 * m + e;              // the sample in the chunk
#pragma unroll
        for (int k = 0; k < kComps; ++k)
          w[k][j * kBytes / 4] |= (static_cast<uint32_t>(s[k]) & kMask)
                                  << (8 * ((j * kBytes) & 3));
      }
    }
#pragma unroll
    for (int k = 0; k < kComps; ++k)
      *reinterpret_cast<uint4*>(
          static_cast<char*>(a.out) +
          (kShard ? ((static_cast<int64_t>(k) * (a.r1 - a.r0) + y - a.r0) *
                         a.w + x) * kBytes
                  : (((static_cast<int64_t>(f) * kComps + k) * a.h + y) *
                         a.w + x) * kBytes)) =
          make_uint4(w[k][0], w[k][1], w[k][2], w[k][3]);
  }
}

// kFinal: level 0, one CTA a frame's tile over its kComps components, the
// finish folded into the copy-out; else one CTA a plane's tile (kComps 1).
// kVec: 16-byte loads of the band rows, else a word at a time. kShard: the
// shard mode (dwt_common.cuh), an image's band rows in, rows r0 .. r1 out.
template <bool kLossy, int kComps, bool kFinal, bool kVec, bool kShard>
__global__ void __launch_bounds__(kRevThreads, kComps == 1 ? 4 : 2)
dwt_reverse_kernel(const RevArgs a) {
  using V = typename Tile<kLossy>::V;
  constexpr int H = Tile<kLossy>::kHalo;
  constexpr int N = kStrip + 2 * H;            // a strip with its halo
  constexpr int kRows = kTile + 2 * H;         // the tile's rows with halo
  constexpr int kPasses = (kRows + kLoadRows - 1) / kLoadRows;
  extern __shared__ __align__(16) unsigned char smem[];
  V* S = reinterpret_cast<V*>(smem);
  V* B = S + kRows * kPitchS;
  V* Tx = B + kRows * kPitchB;                 // tiles of components < last
  auto tile = [&](int k) -> V* {
    return k == kComps - 1 ? S : Tx + k * kTile * kPitchT;
  };
  // shard mode: the tiles start at the shard's first row r0 (even)
  const int y0 = kShard ? a.r0 + blockIdx.y * kTile : blockIdx.y * kTile;
  const int x0 = blockIdx.x * kTile;
  const int t = threadIdx.x;
  const int f = kFinal ? blockIdx.z : blockIdx.z % a.batch;
  const int h2 = a.h >> 1, w2 = a.w >> 1;

#pragma unroll 1
  for (int k = 0; k < kComps; ++k) {
    const int comp = kFinal ? k : blockIdx.z / a.batch;
    const int p = comp * a.batch + f;
    const int32_t* blocks =
        (comp == 0 ? a.blocks[0] : (comp == 1 ? a.blocks[1] : a.blocks[2])) +
        f * a.plane_words;

    // load (Loader): with kVec a thread issues all its 16-byte loads
    // before it converts any, else it reads its chunks a word at a time
    if (t < kLoadThreads) {
      const Loader<kLossy, kShard> L(a, blocks, p, t, x0);
      const int r0 = t / kLoadLanes;
      const int yb = (y0 >> 1) - H / 2 + (r0 >> 1);  // band row of r0
      V* dst = S + r0 * kPitchS + L.dx * kStageCols + kWords * L.q -
               (kLead - 2);                          // staged column j
      auto put = [&](int i, const uint32_t (&w)[kWords]) {
#pragma unroll
        for (int e = 0; e < kWords; ++e) {
          const int j = kWords * L.q + e - (kLead - 2);
          if (j >= 0 && j < kStageCols)
            dst[i * kLoadRows * kPitchS + e] = L.value(a, w[e]);
        }
      };
      if constexpr (kVec) {
        const bool x_in = L.x >= 0 && L.x < w2;
        uint4 u[kPasses];
#pragma unroll
        for (int i = 0; i < kPasses; ++i) {
          const int y = yb + kLoadRows / 2 * i;
          u[i] = make_uint4(0, 0, 0, 0);
          if constexpr (kShard) {       // the buffer's band rows
            if (r0 + kLoadRows * i < kRows && x_in && y >= a.in0 &&
                y < a.in1)
              u[i] = __ldg(reinterpret_cast<const uint4*>(L.at(a, y, 0)));
          } else {
            if (r0 + kLoadRows * i < kRows && x_in && y >= 0 && y < h2)
              u[i] = __ldg(reinterpret_cast<const uint4*>(L.at(a, y, 0)));
          }
        }
#pragma unroll
        for (int i = 0; i < kPasses; ++i)
          if (r0 + kLoadRows * i < kRows)
            put(i, {u[i].x, u[i].y, u[i].z, u[i].w});
      } else {
#pragma unroll 1
        for (int i = 0; r0 + kLoadRows * i < kRows; ++i) {
          const int y = yb + kLoadRows / 2 * i;
          uint32_t w[kWords];
#pragma unroll
          for (int e = 0; e < kWords; ++e) {
            if constexpr (kShard)       // the buffer's band rows
              w[e] = y >= a.in0 && y < a.in1 && L.x + e >= 0 && L.x + e < w2
                         ? __ldg(L.at(a, y, e))
                         : 0u;
            else
              w[e] = y >= 0 && y < h2 && L.x + e >= 0 && L.x + e < w2
                         ? __ldg(L.at(a, y, e))
                         : 0u;
          }
          put(i, w);
        }
      }
    }
    __syncthreads();

    // horizontal: strip s of tile row r (plane row y0 - H + r), plane
    // columns g0 .. g0 + N: even ones from the L band, odd from the H band
    if (t < kStrips * kRows) {
      const int r = t % kRows, s = t / kRows;
      const int gy = y0 - H + r, g0 = x0 + kStrip * s - H;
      if (gy >= 0 && gy < a.h && g0 + H < a.w) {
        const V* src = S + r * kPitchS + kStrip / 2 * s + 2 - H / 2;
        V v[N];
#pragma unroll
        for (int i = 0; i < N; ++i) v[i] = src[(i & 1) * kStageCols + (i >> 1)];
        if (g0 <= 0 || g0 + N >= a.w)
          lift_reverse_regs<kLossy, true, false>(v, -g0, a.w - 1 - g0, a.c);
        else
          lift_reverse_regs<kLossy, false, false>(v, 0, 0, a.c);
#pragma unroll
        for (int i = 0; i < kStrip; ++i)
          B[r * kPitchB + kStrip * s + i] = v[H + i];
      }
    }
    __syncthreads();

    // vertical: strip s of tile column c, plane rows g0 .. g0 + N
    if (t < kStrips * kTile) {
      const int c = t % kTile, s = t / kTile;
      const int g0 = y0 + kStrip * s - H;
      if (g0 + H < row_end<kShard>(a) && x0 + c < a.w) {
        V v[N];
#pragma unroll
        for (int i = 0; i < N; ++i) v[i] = B[(kStrip * s + i) * kPitchB + c];
        if (g0 <= 0 || g0 + N >= a.h)
          lift_reverse_regs<kLossy, true, true>(v, -g0, a.h - 1 - g0, a.c);
        else
          lift_reverse_regs<kLossy, false, true>(v, 0, 0, a.c);
        V* dst = tile(k);
#pragma unroll
        for (int i = 0; i < kStrip; ++i)
          dst[(kStrip * s + i) * kPitchT + c] = v[H + i];
      }
    }
  }
  __syncthreads();

  // copy-out
  if constexpr (kFinal) {
    if (a.type == kU8 || a.type == kI8)
      put_samples<kLossy, kComps, 1, kShard>(a, tile, f, y0, x0);
    else
      put_samples<kLossy, kComps, 2, kShard>(a, tile, f, y0, x0);
  } else {
    // a tile row of the next level's LL plane as 16 chunks of 4 values
    // (shard mode: the rows from r0 of component blockIdx.z)
    V* out = static_cast<V*>(a.out) +
             (kShard ? static_cast<int64_t>(blockIdx.z) * (a.r1 - a.r0) * a.w
                     - static_cast<int64_t>(a.r0) * a.w
                     : static_cast<int64_t>(blockIdx.z) * a.h * a.w);
    constexpr int kChunks = kTile / kWords;
    for (int it = t; it < kTile * kChunks; it += kRevThreads) {
      const int r = it / kChunks, x = x0 + kWords * (it % kChunks);
      if (y0 + r >= row_end<kShard>(a) || x >= a.w) continue;
      const V* src = S + r * kPitchT + x - x0;
      V* dst = out + static_cast<int64_t>(y0 + r) * a.w + x;
      if ((a.w & 3) == 0) {
        *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
      } else {
#pragma unroll
        for (int e = 0; e < kWords; ++e)
          if (x + e < a.w) dst[e] = src[e];
      }
    }
  }
}

// Launches one variant with its dynamic shared memory; above the default
// 48 KB (RGB at level 0) the limit is raised first, once a device.
template <bool kLossy, int kComps, bool kFinal, bool kVec, bool kShard = false>
cudaError_t launch(const RevArgs& a, dim3 grid, cudaStream_t s) {
  constexpr int bytes = smem_bytes<kLossy, kComps>();
  auto* kernel = dwt_reverse_kernel<kLossy, kComps, kFinal, kVec, kShard>;
  if constexpr (bytes > 48 * 1024) {
    static std::atomic<unsigned long long> raised{0};  // a bit a device
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return err;
    const unsigned long long bit = dev < 64 ? 1ull << dev : 0;
    if (!(raised.load() & bit)) {
      err = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
      if (err != cudaSuccess) return err;
      raised.fetch_or(bit);
    }
  }
  kernel<<<grid, kRevThreads, bytes, s>>>(a);
  return cudaGetLastError();
}

template <bool kLossy, bool kVec>
cudaError_t launch_level(const RevArgs& a, int level, int planes,
                         cudaStream_t s) {
  const dim3 grid((a.w + kTile - 1) / kTile, (a.h + kTile - 1) / kTile,
                  static_cast<unsigned>(level ? planes : a.batch));
  if (level) return launch<kLossy, 1, false, kVec>(a, grid, s);
  if (a.comps == 3) return launch<kLossy, 3, true, kVec>(a, grid, s);
  return launch<kLossy, 1, true, kVec>(a, grid, s);
}

// The shard mode's launch: the rows [r0, r1), the finish at level 0 when
// `with_finish`.
template <bool kLossy, bool kVec>
cudaError_t launch_shard(const RevArgs& a, bool with_finish, cudaStream_t s) {
  const dim3 grid((a.w + kTile - 1) / kTile,
                  (a.r1 - a.r0 + kTile - 1) / kTile,
                  static_cast<unsigned>(with_finish ? 1 : a.comps));
  if (!with_finish) return launch<kLossy, 1, false, kVec, true>(a, grid, s);
  if (a.comps == 3) return launch<kLossy, 3, true, kVec, true>(a, grid, s);
  return launch<kLossy, 1, true, kVec, true>(a, grid, s);
}

}  // namespace
}  // namespace dwt
}  // namespace picsong

// X4 over a batch: `levels` launches on `stream`, each checked; no
// synchronisation. `vec` says the codeblocks' bases are multiples of 16
// bytes (the wrapper's check): a level whose bands are a multiple of 4
// words wide then loads 16-byte chunks, else a word at a time. `scratch`
// as in picsong_dwt_forward; `out` is (batch, comps, h, w) samples of
// `type`. Returns the first launch's cudaError_t, or 0.
extern "C" int picsong_dwt_reverse(const int32_t* b0, const int32_t* b1,
                                   const int32_t* b2, int vec, int batch,
                                   int comps, int h, int w, int levels,
                                   int lossy, int offset, int lo, int hi,
                                   int type, const float* consts,
                                   void* scratch, void* out, void* stream) {
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
    const bool v = vec && ((a.w >> 1) & 3) == 0;
    const cudaError_t err =
        lossy ? (v ? launch_level<true, true>(a, level, planes, s)
                   : launch_level<true, false>(a, level, planes, s))
              : (v ? launch_level<false, true>(a, level, planes, s)
                   : launch_level<false, false>(a, level, planes, s));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}

// X4's shard mode: one launch of level `level` of one image's `comps`
// planes (h x w, the level's plane) on `stream`, rebuilding and storing
// the plane rows [r0, r1) (even) from the band rows [in0, in1) (the
// shard's and its halo, clipped at the band) of LL, HL, LH and HH, each
// (comps, in1 - in0, w / 2): LL as values' bits above the deepest level,
// else quantized (dequantized here for 9/7). Writes (comps, r1 - r0, w)
// int32 / float values to `out`, or with `with_finish` (level 0) the finish's
// samples of `type`. `vec`: the wrapper's check that the bands' bases are
// multiples of 16 bytes (used where w / 2 is a multiple of 4). Returns
// the launch's cudaError_t, or 0.
extern "C" int picsong_dwt_reverse_shard(
    const void* ll, const void* hl, const void* lh, const void* hh, int vec,
    int comps, int h, int w, int level, int levels, int lossy, int with_finish,
    int offset, int lo, int hi, int type, const float* consts, int in0,
    int in1, int r0, int r1, void* out, void* stream) {
  using namespace picsong::dwt;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  RevArgs a = {};
  a.band[0] = ll;
  a.band[1] = hl;
  a.band[2] = lh;
  a.band[3] = hh;
  a.out = out;
  a.batch = 1;
  a.comps = comps;
  a.h = h;
  a.w = w;
  a.deepest = level == levels - 1;
  a.offset = offset;
  a.lo = lo;
  a.hi = hi;
  a.type = type;
  a.in0 = in0;
  a.in1 = in1;
  a.r0 = r0;
  a.r1 = r1;
  a.c = level_consts(consts, level);
  const bool v = vec && ((w >> 1) & 3) == 0;
  const cudaError_t err =
      lossy ? (v ? launch_shard<true, true>(a, with_finish != 0, s)
                 : launch_shard<true, false>(a, with_finish != 0, s))
            : (v ? launch_shard<false, true>(a, with_finish != 0, s)
                 : launch_shard<false, false>(a, with_finish != 0, s));
  return static_cast<int>(err);
}
