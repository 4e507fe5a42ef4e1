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
// Two launches a call, on the caller's stream:
//  1. scan_kernel: one CTA of kScanThreads threads. Thread t takes the
//     chunk [t*c, t*c + c) of blocks, c = ceil(N / kScanThreads): it sums
//     its counts, the CTA scans the thread sums (warp shuffles, then one
//     warp over the warp totals), and each thread writes the exclusive
//     offsets of its chunk. offsets[N] is the payload total. Unpacking,
//     it reads the sizes from the codestream as unsigned shorts and also
//     writes them out as int32.
//  2. pack_kernel / unpack_kernel: one warp per codeblock, kCopyWarps a
//     CTA. Pack: lane 0 writes the block's (MSB, size) pair, the lanes
//     copy words 1..size-1 to 9 + 2N + offset[i] (block 0 also writes the
//     header and the final filler, so every short of the output is
//     written). Unpack: the lanes write the block's whole 4096-word row
//     with 16-byte stores: the MSB word, the payload words as 0..65535,
//     then -1.
//
// What bounds it on this card: at the main path's size (1024 codeblocks,
// a 3.17 MB codestream) the bytes take 3-6 us at 3.35 TB/s, below one
// launch's latency, so both directions are launch-bound; the scan's one
// CTA is a latency chain of two barriers. Counts are clamped to 0..4095
// and the payload is never read or written past `capacity` words, so a
// corrupt size cannot move a store out of the buffers; the callers check
// sizes before (pack.block_fields). Flat indices are 64-bit.
#include <cstdint>
#include <cuda_runtime.h>

namespace picsong {
namespace {

constexpr int kHeaderShorts = 9;
constexpr int kWords = 4096;       // a codeblock's stream row
constexpr int kScanThreads = 1024;
constexpr int kCopyWarps = 8;      // codeblocks a copy CTA
constexpr int kUnroll = 4;         // payload words a lane has in flight

struct Header {
  int16_t s[kHeaderShorts];
};

__device__ __forceinline__ int count_of(int size) {
  return min(max(size - 1, 0), kWords - 1);
}

// Block i's payload words inside a buffer of `capacity` payload words.
__device__ __forceinline__ int words_in(const long long* __restrict__ offsets,
                                        int i, long long capacity) {
  const long long off = offsets[i], room = capacity - off;
  const long long c = offsets[i + 1] - off;
  return static_cast<int>(room <= 0 ? 0 : (c < room ? c : room));
}

// The size of block i: from the int32 sizes, or from the codestream's
// pair as an unsigned short.
template <bool kFromCode>
__device__ __forceinline__ int size_of(const int32_t* __restrict__ sizes,
                                       const int16_t* __restrict__ code,
                                       int i) {
  if (kFromCode)
    return static_cast<uint16_t>(code[kHeaderShorts + 2 * i + 1]);
  return sizes[i];
}

template <bool kFromCode>
__global__ void __launch_bounds__(kScanThreads)
scan_kernel(const int32_t* __restrict__ sizes,
            const int16_t* __restrict__ code, int n,
            long long* __restrict__ offsets, int32_t* __restrict__ sizes_out) {
  __shared__ long long warp_sums[kScanThreads / 32];
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int chunk = (n + kScanThreads - 1) / kScanThreads;
  const int begin = min(t * chunk, n), end = min(begin + chunk, n);
  long long sum = 0;
  for (int i = begin; i < end; ++i) {
    const int size = size_of<kFromCode>(sizes, code, i);
    if (kFromCode) sizes_out[i] = size;
    sum += count_of(size);
  }
  // inclusive scan of the thread sums within the warp
  long long incl = sum;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const long long v = __shfl_up_sync(0xffffffffu, incl, d);
    if (lane >= d) incl += v;
  }
  if (lane == 31) warp_sums[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    long long w = warp_sums[lane];
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const long long v = __shfl_up_sync(0xffffffffu, w, d);
      if (lane >= d) w += v;
    }
    warp_sums[lane] = w;   // inclusive over warps
  }
  __syncthreads();
  long long run = incl - sum + (warp ? warp_sums[warp - 1] : 0);
  for (int i = begin; i < end; ++i) {
    offsets[i] = run;
    run += count_of(size_of<kFromCode>(sizes, code, i));
  }
  if (t == kScanThreads - 1) offsets[n] = run;   // the payload total
}

__device__ __forceinline__ int16_t low16(int32_t v) {
  return static_cast<int16_t>(static_cast<uint16_t>(v & 0xFFFF));
}

__global__ void __launch_bounds__(kCopyWarps * 32)
pack_kernel(const int32_t* __restrict__ streams,
            const int32_t* __restrict__ sizes, int n, Header header,
            long long capacity, const long long* __restrict__ offsets,
            int16_t* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const long long body = kHeaderShorts + 2LL * n;
  if (blockIdx.x == 0) {
    if (threadIdx.x < kHeaderShorts) out[threadIdx.x] = header.s[threadIdx.x];
    if (threadIdx.x == kHeaderShorts)
      out[body + (offsets[n] < capacity ? offsets[n] : capacity)] = -1;
  }
  const int i = blockIdx.x * kCopyWarps + (threadIdx.x >> 5);
  if (i >= n) return;
  const int32_t* __restrict__ row = streams + static_cast<long long>(i) * kWords;
  if (lane == 0) {
    out[kHeaderShorts + 2 * static_cast<long long>(i)] = low16(row[0]);
    out[kHeaderShorts + 2 * static_cast<long long>(i) + 1] = low16(sizes[i]);
  }
  const int c = words_in(offsets, i, capacity);
  int16_t* __restrict__ dst = out + body + offsets[i];
  const int32_t* __restrict__ src = row + 1;
  for (int j = lane; j < c; j += 32 * kUnroll) {
    int32_t v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int k = j + 32 * u;
      v[u] = k < c ? src[k] : 0;
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int k = j + 32 * u;
      if (k < c) dst[k] = low16(v[u]);
    }
  }
}

__global__ void __launch_bounds__(kCopyWarps * 32)
unpack_kernel(const int16_t* __restrict__ code, int n, long long payload,
              const long long* __restrict__ offsets,
              int32_t* __restrict__ streams) {
  const int lane = threadIdx.x & 31;
  const int i = blockIdx.x * kCopyWarps + (threadIdx.x >> 5);
  if (i >= n) return;
  const int msb = static_cast<uint16_t>(code[kHeaderShorts + 2 * i]);
  const int c = words_in(offsets, i, payload);
  const uint16_t* __restrict__ src = reinterpret_cast<const uint16_t*>(code) +
                                     kHeaderShorts + 2LL * n + offsets[i];
  int4* __restrict__ row =
      reinterpret_cast<int4*>(streams + static_cast<long long>(i) * kWords);
#pragma unroll 4
  for (int q = lane; q < kWords / 4; q += 32) {
    int v[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int w = 4 * q + u;             // word w holds payload word w-1
      v[u] = w == 0 ? msb : (w <= c ? static_cast<int>(src[w - 1]) : -1);
    }
    row[q] = make_int4(v[0], v[1], v[2], v[3]);
  }
}

}  // namespace
}  // namespace picsong

// C entry point of the pack: streams (N, 4096) and sizes (N,) int32,
// contiguous, on the device; header: 9 shorts on the host, or null for the
// 0xFFFF filler (they travel as a launch argument); capacity: the payload
// words `out` holds (out has 9 + 2N + capacity + 1 shorts); offsets: N + 1
// int64 of scratch, offsets[N] the payload total afterwards. N may be 0.
// Launches on `stream`, does not synchronise, returns cudaGetLastError().
extern "C" int picsong_pack(const int32_t* streams, const int32_t* sizes,
                            int n, const uint16_t* header, long long capacity,
                            long long* offsets, int16_t* out, void* stream) {
  using namespace picsong;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  Header h;
  for (int k = 0; k < kHeaderShorts; ++k)
    h.s[k] = header ? static_cast<int16_t>(header[k]) : int16_t(-1);
  scan_kernel<false><<<1, kScanThreads, 0, s>>>(sizes, nullptr, n, offsets,
                                                nullptr);
  cudaError_t rc = cudaGetLastError();
  if (rc != cudaSuccess) return static_cast<int>(rc);
  const int grid = n > 0 ? (n + kCopyWarps - 1) / kCopyWarps : 1;
  pack_kernel<<<grid, kCopyWarps * 32, 0, s>>>(streams, sizes, n, h, capacity,
                                              offsets, out);
  return static_cast<int>(cudaGetLastError());
}

// C entry point of the unpack: code, the int16 codestream of N >= 1
// codeblocks holding at least 9 + 2N + payload + 1 shorts, on the device;
// offsets: N + 1 int64 of scratch; streams (N, 4096) int32, 16-byte
// aligned, and sizes (N,) int32 are written. Launches on `stream`, does
// not synchronise, returns cudaGetLastError().
extern "C" int picsong_unpack(const int16_t* code, int n, long long payload,
                              long long* offsets, int32_t* streams,
                              int32_t* sizes, void* stream) {
  using namespace picsong;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  scan_kernel<true><<<1, kScanThreads, 0, s>>>(nullptr, code, n, offsets,
                                               sizes);
  cudaError_t rc = cudaGetLastError();
  if (rc != cudaSuccess) return static_cast<int>(rc);
  unpack_kernel<<<(n + kCopyWarps - 1) / kCopyWarps, kCopyWarps * 32, 0, s>>>(
      code, n, payload, offsets, streams);
  return static_cast<int>(cudaGetLastError());
}
