// X3, the codestream pack and unpack, for Hopper (sm_90a).
//
// Replaces the XLA programs StagedBPC._pack_dense_impl and
// _unpack_dense_impl (picsong_tpu/entropy/bpc_jax.py:1818, :1832): a
// prefix sum over the codeblocks' payload counts (size - 1), then each
// block's payload words relocated to its offset. The reference does the
// same with a CUB InclusiveSum and the relocation kernel
// buildBitStreamLUTBS (BitStreamBuilder.cu:106, 176, 297).
//
// Wire layout (int16 shorts; the host views them as uint16):
//   shorts[0..8]    header, or 0xFFFF filler
//   shorts[9+2i]    codeblock i's MSB word (stream word 0), low 16 bits
//   shorts[9+2i+1]  codeblock i's size (words used, the MSB word too)
//   payload         words 1..size-1 of every codeblock, low 16 bits,
//                   concatenated in block order
//   final short     0xFFFF filler
//
// One launch a call, on the caller's stream. A CTA takes a tile of
// kTileBlocks consecutive codeblocks, one warp a codeblock:
//  1. The offsets: a single-pass scan with decoupled look-back. Warp 0
//     reads the tile's sizes (unpacking, from the codestream's pairs as
//     unsigned shorts, and writes them out), scans their counts with
//     __shfl_up_sync and publishes the tile's aggregate in its 64-bit
//     status word (flag and value in one store). It then reads its
//     predecessors' words 32 * kLookBack at a time, all in flight
//     together, until it meets an inclusive prefix, and publishes its
//     own. Tiles follow blockIdx.x, so a tile waits only on tiles
//     dispatched before it. The last tile writes the payload total after
//     the status words, for the wrapper's one read.
//  2. The payload, through a buffer of kStage shorts a warp in shared
//     memory, a window at a time. Pack: the warp loads its row's words
//     with aligned 16-byte loads (rows are 16 KB apart), kEarly of its
//     first window's slots before the look-back, writes their low 16 bits
//     into the buffer at their place in the output's 16-byte chunks, then
//     stores each chunk that lies inside the block's range with one
//     16-byte store; the block's first and last chunks, shared with its
//     neighbours, take 2-byte stores. Unpack: the windows past the block's
//     count are -1 whatever the offset, and the warps write them while
//     warp 0 looks back; then the warp reads its payload with aligned
//     16-byte loads, rounded out to 16-byte boundaries on the absolute
//     address (the codestream may be a view that is only 2-byte aligned),
//     the next window's in flight while a window is stored, and copies
//     them to the buffer as they are; each 16-byte store of the row takes
//     its four shorts from the buffer at the block's shift: the MSB word,
//     the payload words as 0..65535, then -1.
//
// What bounds it on this card: the bytes (at the main path's 1024
// codeblocks, a 3.17 MB codestream, 3-6 us at 3.35 TB/s), within one
// launch's latency, so the design keeps to one launch, and the look-back,
// a chain of round trips to L2, is kept short and overlapped with traffic
// that does not need the offsets. Counts are clamped to 0..4095 and the
// payload is never read or written past `capacity` words, so a corrupt
// size cannot move a store out of the buffers; the callers check sizes
// before (pack.block_fields). Flat indices are 64-bit.
#include <cstdint>
#include <cuda_runtime.h>

namespace picsong {
namespace {

constexpr int kHeaderShorts = 9;
constexpr int kWords = 4096;       // a codeblock's stream row
constexpr int kTileBlocks = 8;     // codeblocks (warps) a CTA: a scan tile
constexpr int kThreads = kTileBlocks * 32;
constexpr int kStage = 1024;       // payload shorts a warp stages a window
constexpr int kWindows = kWords / kStage;   // windows of a row
constexpr int kLookBack = 4;       // status words a lane reads a round
// int64 words from one tile's status word to the next: one 128-byte line
// each, so that tiles polling their predecessors do not queue on a line
constexpr int kStatusStride = 16;
// pack: the row's 16-byte words a window reads, the window's kStage / 4
// and the 3 its chunks' shift reaches past either end; unpack: 16-byte
// chunks of the codestream, kStage / 8 and one more for the shift
constexpr int kPackLoads = (kStage / 4 + 3 + 31) / 32;
constexpr int kUnpackLoads = (kStage / 8 + 1 + 31) / 32;
// pack slots a lane of warps 1.. loads before the look-back: more would
// queue the look-back's own loads behind them
constexpr int kEarly = 3;
// the pack's staging buffer reaches 9 shorts before a window and 10 past
// it: the words of a slot are staged without a test each
constexpr int kPad = 16;

static_assert(kTileBlocks <= 32, "warp 0 scans a tile's counts");
static_assert(kWords % kStage == 0 && kStage % 256 == 0, "whole windows");

// a status word: the flag in the top two bits, the value below; flag and
// value travel in one single-copy-atomic 64-bit access
constexpr int kFlagShift = 62;
constexpr unsigned long long kAggregate = 1ull << kFlagShift;
constexpr unsigned long long kPrefix = 2ull << kFlagShift;
constexpr unsigned long long kValue = kAggregate - 1;

struct Header {
  int16_t s[kHeaderShorts];
};

__device__ __forceinline__ int count_of(int size) {
  return min(max(size - 1, 0), kWords - 1);
}

__device__ __forceinline__ int16_t low16(int32_t v) {
  return static_cast<int16_t>(static_cast<uint16_t>(v & 0xFFFF));
}

// A tile's status word is read by no other data than itself, so relaxed
// accesses at device scope suffice: they bypass the SM's L1 (never the
// non-coherent path of __ldg), and several stay in flight together.
__device__ __forceinline__ void publish(unsigned long long* status, int tile,
                                        unsigned long long v) {
  asm volatile("st.relaxed.gpu.global.u64 [%0], %1;"
               ::"l"(status + static_cast<long long>(kStatusStride) * tile),
               "l"(v) : "memory");
}

__device__ __forceinline__ unsigned long long observe(
    const unsigned long long* status, int tile) {
  unsigned long long v;
  asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];" : "=l"(v)
               : "l"(status + static_cast<long long>(kStatusStride) * tile)
               : "memory");
  return v;
}

__device__ __forceinline__ long long warp_sum(long long v) {
#pragma unroll
  for (int d = 16; d; d >>= 1) v += __shfl_xor_sync(0xffffffffu, v, d);
  return v;
}

// The first half of a tile's scan, by the whole of warp 0, lane l holding
// the count of the tile's codeblock l (0 past the tile's blocks): the
// lanes' inclusive sums, and the tile's aggregate published (tile 0: its
// inclusive prefix).
struct TileScan {
  int incl;
  long long aggregate;
};

__device__ __forceinline__ TileScan tile_publish(
    unsigned long long* __restrict__ status, int tile, int count, int lane) {
  TileScan t;
  t.incl = count;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int v = __shfl_up_sync(0xffffffffu, t.incl, d);
    if (lane >= d) t.incl += v;
  }
  t.aggregate = __shfl_sync(0xffffffffu, t.incl, 31);
  if (lane == 0)
    publish(status, tile, (tile ? kAggregate : kPrefix) | t.aggregate);
  return t;
}

// The second half, by the whole of warp 0: the counts before the tile.
// A round reads 32 * kLookBack predecessors, nearest first (lane l, read
// r: the tile l + 32 r before `nearest`), waits until each has published,
// and stops at the nearest inclusive prefix; before tile 0 lies a prefix
// of 0. The tile then publishes its own inclusive prefix.
__device__ long long tile_base(unsigned long long* __restrict__ status,
                               int tile, int lane, long long aggregate) {
  if (tile == 0) return 0;
  constexpr int kNone = 32 * kLookBack;
  long long base = 0;
  for (int nearest = tile - 1;; nearest -= kNone) {
    unsigned long long s[kLookBack];
#pragma unroll
    for (int r = 0; r < kLookBack; ++r) {
      const int j = nearest - lane - 32 * r;
      s[r] = j >= 0 ? observe(status, j) : kPrefix;
    }
    // reread every word not yet published, all in flight together
    for (;;) {
      bool pending = false;
#pragma unroll
      for (int r = 0; r < kLookBack; ++r)
        pending |= (s[r] >> kFlagShift) == 0;
      if (!__any_sync(0xffffffffu, pending)) break;
#pragma unroll
      for (int r = 0; r < kLookBack; ++r)
        if ((s[r] >> kFlagShift) == 0)
          s[r] = observe(status, nearest - lane - 32 * r);
    }
    int stop = kNone;
#pragma unroll
    for (int r = 0; r < kLookBack; ++r) {
      const unsigned p = __ballot_sync(0xffffffffu, (s[r] & kPrefix) != 0);
      if (p && stop == kNone) stop = 32 * r + __ffs(p) - 1;
    }
    long long part = 0;
#pragma unroll
    for (int r = 0; r < kLookBack; ++r)
      if (lane + 32 * r <= stop) part += static_cast<long long>(s[r] & kValue);
    base += warp_sum(part);
    if (stop < kNone) break;
  }
  if (lane == 0) publish(status, tile, kPrefix | (base + aggregate));
  return base;
}

// Row words 4q..4q+3 for q = kStage / 4 * g - 2 + lane + 32s: window g's
// words (and the shift's reach), those of the row's first `count` payload
// words.
__device__ __forceinline__ bool pack_slot(int g, int s, int lane, int count,
                                          int* q) {
  const int k = lane + 32 * s;
  *q = kStage / 4 * g - 2 + k;
  return k < kStage / 4 + 3 && *q >= 0 && 4 * *q <= count && count > 0;
}

// Slots kFrom..kTo-1 of window g.
template <int kFrom = 0, int kTo = kPackLoads>
__device__ __forceinline__ void pack_load(const int4* __restrict__ row,
                                          int g, int lane, int count,
                                          int4 (&v)[kPackLoads]) {
#pragma unroll
  for (int s = kFrom; s < kTo; ++s) {
    int q;
    if (pack_slot(g, s, lane, count, &q)) v[s] = row[q];
  }
}

__device__ __forceinline__ void pack_pair(int16_t* __restrict__ out, int i,
                                          const int4* __restrict__ row,
                                          const int32_t* __restrict__ sizes) {
  out[kHeaderShorts + 2LL * i] =
      low16(reinterpret_cast<const int32_t*>(row)[0]);
  out[kHeaderShorts + 2LL * i + 1] = low16(sizes[i]);
}

__global__ void __launch_bounds__(kThreads)
pack_kernel(const int32_t* __restrict__ streams,
            const int32_t* __restrict__ sizes, int n, Header header,
            long long capacity, unsigned long long* __restrict__ status,
            int16_t* __restrict__ out) {
  __shared__ __align__(16) uint16_t stage[kTileBlocks][kStage + 2 * kPad];
  __shared__ long long offsets[kTileBlocks];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int tile = blockIdx.x, i = tile * kTileBlocks + warp;
  const long long body = kHeaderShorts + 2LL * n;
  const int4* __restrict__ row = reinterpret_cast<const int4*>(
      streams + static_cast<long long>(i < n ? i : 0) * kWords);
  const int count = i < n ? count_of(sizes[i]) : 0;
  int4 v[kPackLoads];
  if (warp == 0) {
    const int k = tile * kTileBlocks + lane;
    const int c = lane < kTileBlocks && k < n ? count_of(sizes[k]) : 0;
    const TileScan t = tile_publish(status, tile, c, lane);
    const long long base = tile_base(status, tile, lane, t.aggregate);
    if (lane < kTileBlocks) offsets[lane] = base + t.incl - c;
    const long long total = base + t.aggregate;
    if (lane == 0 && tile == gridDim.x - 1) {
      status[static_cast<long long>(kStatusStride) * gridDim.x] = total;
      out[body + (total < capacity ? total : capacity)] = -1;
    }
  } else {
    // the first window's words do not depend on the offset
    pack_load<0, kEarly>(row, 0, lane, count, v);
    if (i < n && lane == 0) pack_pair(out, i, row, sizes);
  }
  if (tile == 0 && threadIdx.x < kHeaderShorts)
    out[threadIdx.x] = header.s[threadIdx.x];
  __syncthreads();
  if (i >= n) return;
  if (warp == 0) {
    pack_load(row, 0, lane, count, v);
    if (lane == 0) pack_pair(out, i, row, sizes);
  } else {
    pack_load<kEarly, kPackLoads>(row, 0, lane, count, v);
  }
  const long long off = offsets[warp], room = capacity - off;
  const int c = static_cast<int>(room <= 0 ? 0 : (count < room ? count : room));
  const long long first = body + off;       // the block's first short
  const int shift = static_cast<int>(first & 7);
  const long long chunk0 = first - shift;   // its first 16-byte chunk
  const long long end = first + c;
  uint16_t* buf = stage[warp] + kPad;
  const int windows = (shift + c + kStage - 1) / kStage;
  for (int g = 0; g < windows; ++g) {
    // word w goes to buf[w - 1 + shift - kStage * g]: a word outside the
    // block's payload lands where no store of the window reads
#pragma unroll
    for (int s = 0; s < kPackLoads; ++s) {
      int q;
      if (!pack_slot(g, s, lane, count, &q)) continue;
      uint16_t* at = buf + 4 * q - 1 + shift - kStage * g;
      at[0] = static_cast<uint16_t>(v[s].x);
      at[1] = static_cast<uint16_t>(v[s].y);
      at[2] = static_cast<uint16_t>(v[s].z);
      at[3] = static_cast<uint16_t>(v[s].w);
    }
    __syncwarp();
    if (g + 1 < windows) pack_load(row, g + 1, lane, count, v);
#pragma unroll
    for (int s = 0; s < kStage / 8 / 32; ++s) {
      const int j = lane + 32 * s;
      const long long lo = chunk0 + static_cast<long long>(kStage) * g + 8 * j;
      if (lo >= first && lo + 8 <= end) {
        *reinterpret_cast<uint4*>(out + lo) =
            *reinterpret_cast<const uint4*>(buf + 8 * j);
      } else if (lo < end && lo + 8 > first) {
        for (int t = 0; t < 8; ++t)
          if (lo + t >= first && lo + t < end)
            out[lo + t] = static_cast<int16_t>(buf[8 * j + t]);
      }
    }
    __syncwarp();
  }
}

// Unpack window g's 16-byte chunks of the codestream: from `base`, the
// chunk of its row word kStage * g, the chunks lo..hi that hold its
// payload words (none: hi < lo), payload word w being short s0 + w - 1.
struct Window {
  long long base, lo, hi;
};

__device__ __forceinline__ Window unpack_window(long long s0, int c, int g) {
  const int w_lo = g ? kStage * g : 1, w_hi = min(c, kStage * (g + 1) - 1);
  Window win;
  win.base = (s0 + static_cast<long long>(kStage) * g - 1) >> 3;
  win.lo = (s0 + w_lo - 1) >> 3;
  win.hi = w_lo <= w_hi ? (s0 + w_hi - 1) >> 3 : win.lo - 1;
  return win;
}

__device__ __forceinline__ void unpack_load(const uint4* __restrict__ chunks,
                                            const Window& win, int lane,
                                            uint4 (&v)[kUnpackLoads]) {
#pragma unroll
  for (int s = 0; s < kUnpackLoads; ++s) {
    const long long k = win.base + lane + 32 * s;
    if (k >= win.lo && k <= win.hi) v[s] = chunks[k];
  }
}

// The row words of unpack window g that hold no payload word: the MSB
// word at word 0, -1 elsewhere.
__device__ __forceinline__ void fill_window(int4* __restrict__ row, int g,
                                            int msb, int lane) {
#pragma unroll
  for (int t = 0; t < kStage / 4 / 32; ++t) {
    const int q = lane + 32 * t;
    row[kStage / 4 * g + q] =
        make_int4(g == 0 && q == 0 ? msb : -1, -1, -1, -1);
  }
}

__global__ void __launch_bounds__(kThreads)
unpack_kernel(const int16_t* __restrict__ code, int n, long long payload,
              unsigned long long* __restrict__ status,
              int32_t* __restrict__ streams, int32_t* __restrict__ sizes) {
  __shared__ __align__(16) uint16_t stage[kTileBlocks][kStage + 8];
  __shared__ long long offsets[kTileBlocks];
  __shared__ int msbs[kTileBlocks], counts[kTileBlocks];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int tile = blockIdx.x, i = tile * kTileBlocks + warp;
  const uint16_t* __restrict__ u = reinterpret_cast<const uint16_t*>(code);
  // warp 0 reads the tile's pairs and publishes its aggregate before the
  // other warps' stores can queue ahead of the look-back
  TileScan t;
  int lane_count = 0;   // warp 0: the count of the tile's codeblock `lane`
  if (warp == 0) {
    const int k = tile * kTileBlocks + lane;
    const bool mine = lane < kTileBlocks && k < n;
    const int size = mine ? u[kHeaderShorts + 2LL * k + 1] : 0;
    lane_count = mine ? count_of(size) : 0;
    t = tile_publish(status, tile, lane_count, lane);
    if (mine) {
      sizes[k] = size;
      msbs[lane] = u[kHeaderShorts + 2LL * k];
      counts[lane] = lane_count;
    }
  }
  __syncthreads();
  const int msb = i < n ? msbs[warp] : 0, count = i < n ? counts[warp] : 0;
  int4* __restrict__ row =
      reinterpret_cast<int4*>(streams + static_cast<long long>(i) * kWords);
  const int loaded = count ? count / kStage + 1 : 0;  // windows with payload
  if (warp == 0) {
    const long long base = tile_base(status, tile, lane, t.aggregate);
    if (lane < kTileBlocks) offsets[lane] = base + t.incl - lane_count;
  }
  // windows past the block's count hold no payload word whatever the
  // offset: the warps write them while warp 0 looks back
  if (i < n)
    for (int g = loaded; g < kWindows; ++g) fill_window(row, g, msb, lane);
  __syncthreads();
  if (i >= n) return;
  const long long off = offsets[warp], room = payload - off;
  const int c = static_cast<int>(room <= 0 ? 0 : (count < room ? count : room));
  // the codestream in 16-byte chunks from the aligned address below it;
  // payload word w is short s0 + w - 1 of those chunks
  const uintptr_t addr = reinterpret_cast<uintptr_t>(code);
  const uint4* __restrict__ chunks =
      reinterpret_cast<const uint4*>(addr & ~static_cast<uintptr_t>(15));
  const long long s0 =
      kHeaderShorts + 2LL * n + off + static_cast<long long>((addr & 15) >> 1);
  uint16_t* buf = stage[warp];
  Window win = unpack_window(s0, c, 0);
  uint4 v[kUnpackLoads];
  unpack_load(chunks, win, lane, v);
  for (int g = 0; g < loaded; ++g) {
#pragma unroll
    for (int s = 0; s < kUnpackLoads; ++s) {
      const long long k = win.base + lane + 32 * s;
      if (k >= win.lo && k <= win.hi)
        *reinterpret_cast<uint4*>(buf + 8 * (lane + 32 * s)) = v[s];
    }
    __syncwarp();
    // the next window's chunks are in flight while this one is stored
    const Window next = unpack_window(s0, c, g + 1);
    if (g + 1 < loaded) unpack_load(chunks, next, lane, v);
    // word kStage * g + x of the row is buf[at + x]
    const int at = static_cast<int>(
        s0 - 1 + static_cast<long long>(kStage) * g - 8 * win.base);
#pragma unroll
    for (int t = 0; t < kStage / 4 / 32; ++t) {
      const int q = lane + 32 * t, w0 = kStage * g + 4 * q;
      int r[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int w = w0 + e;
        r[e] = w == 0 ? msb
                      : (w <= c ? static_cast<int>(buf[at + 4 * q + e]) : -1);
      }
      row[kStage / 4 * g + q] = make_int4(r[0], r[1], r[2], r[3]);
    }
    __syncwarp();
    win = next;
  }
}

int tiles(int n) { return n > 0 ? (n + kTileBlocks - 1) / kTileBlocks : 1; }

}  // namespace
}  // namespace picsong

// C entry point of the pack: streams (N, 4096) and sizes (N,) int32,
// contiguous, on the device, streams 16-byte aligned; header: 9 shorts on
// the host, or null for the 0xFFFF filler (they travel as a launch
// argument); capacity: the payload words `out` holds (out, 16-byte
// aligned, has 9 + 2N + capacity + 1 shorts); status: max(1, ceil(N /
// 8)) * 16 + 1 int64 of per-call scratch, zero, its last word the payload
// total afterwards. N may be 0. Launches on `stream`, does not
// synchronise, returns cudaGetLastError().
extern "C" int picsong_pack(const int32_t* streams, const int32_t* sizes,
                            int n, const uint16_t* header, long long capacity,
                            unsigned long long* status, int16_t* out,
                            void* stream) {
  using namespace picsong;
  Header h;
  for (int k = 0; k < kHeaderShorts; ++k)
    h.s[k] = header ? static_cast<int16_t>(header[k]) : int16_t(-1);
  pack_kernel<<<tiles(n), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      streams, sizes, n, h, capacity, status, out);
  return static_cast<int>(cudaGetLastError());
}

// C entry point of the unpack: code, the int16 codestream of N >= 1
// codeblocks holding at least 9 + 2N + payload + 1 shorts, on the device,
// 2-byte aligned; status: ceil(N / 8) * 16 + 1 int64 of per-call scratch,
// zero; streams (N, 4096) int32, 16-byte aligned, and sizes (N,) int32
// are written. Launches on `stream`, does not synchronise, returns
// cudaGetLastError().
extern "C" int picsong_unpack(const int16_t* code, int n, long long payload,
                              unsigned long long* status, int32_t* streams,
                              int32_t* sizes, void* stream) {
  using namespace picsong;
  if (n <= 0) return 0;
  unpack_kernel<<<tiles(n), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      code, n, payload, status, streams, sizes);
  return static_cast<int>(cudaGetLastError());
}
