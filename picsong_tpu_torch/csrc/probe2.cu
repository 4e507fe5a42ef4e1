// The rotate/transpose probe for Hopper (sm_90a).
//
// Replaces the Pallas kernel `kernel` of tools/pallas_probe2.py (launched
// by `run`, pallas_call at l.54), a probe of the data movements the Pallas
// BPC decoder leans on: a per-column slab select from a (512, 8, 128) tape,
// a dynamic sublane rotate and a dynamic lane rotate (`pltpu.roll`, which
// follows jnp.roll: out[i] = x[(i - shift) mod n]), a (128, 128) transpose
// and a one-hot (8, 32, 128) contraction. For each column n, with
// q = amt[n] / 1024, s = (amt[n] mod 1024) / 128 and l = amt[n] mod 128:
//   stage[n][j] = tape[4n + q][(-s) mod 8][(j - l) mod 128]
//   rank[i][n]  = |stage[n][i]| mod 8                      (i < 32)
//   out[i][n]   = stage[n][rank[i][n]] + stage[n][i]       (wrapping int32)
//
// What bounds it on this card: latency. The probe moves 32 KB, so its time
// is the chain of dependent memory round trips after the launch, and the
// design keeps that chain at two: amt, then the slab words it addresses.
//
// One CTA of four warps; warp w owns columns 32w .. 32w + 31, and lane c
// loads amt of the warp's column c, once, coalesced. Lane c's column's
// slab row address and lane rotate reach the warp by one __shfl_sync
// from lane c; then lane i loads stage[n][i] of every one of the warp's 32
// columns, at the rotated index (the rotates are an index, not a data
// movement), all 32 loads in flight before the first is used. Only the 32
// stage entries that reach the output are read. stage[n][rank] comes from
// the owning lane by __shfl_sync (a register gather in place of the
// one-hot contraction), and out[i][n] goes into a shared 32 x 33 tile: the
// transpose, padded by one word so that its column writes hit 32 distinct
// banks, which goes out as 32 coalesced 128-byte rows.
//
// Arithmetic is uint32 so that the sum wraps as in JAX, and |INT_MIN| is
// 2^31, whose low three bits are 0 as in jnp. The wrapper guarantees amt in
// [0, 4096), where Mosaic writes every stage row and the slab stays inside
// the tape.
#include <cstdint>
#include <cuda_runtime.h>

namespace picsong {
namespace {

constexpr int kCols = 128;       // codeblock chunk C
constexpr int kOutRows = 32;
constexpr int kSublanes = 8;
constexpr int kLaneWidth = 128;
constexpr int kSlabsPerCol = 4;
constexpr int kWarps = kCols / 32;
constexpr unsigned kAll = 0xffffffffu;

__global__ void __launch_bounds__(kWarps * 32)
probe2_kernel(const int32_t* __restrict__ tape, const int32_t* __restrict__ amt,
              int32_t* __restrict__ out) {
  __shared__ uint32_t tile[kWarps][kOutRows][32 + 1];
  const int lane = threadIdx.x & 31;
  const int w = threadIdx.x >> 5;
  // the first round trip: the lane's own column's amt
  const int a = amt[w * 32 + lane];
  const int q = a >> 10;
  const int row = (kSublanes - ((a >> 7) & (kSublanes - 1))) & (kSublanes - 1);
  // the slab row's first word (a multiple of 128) with the lane rotate l
  // in its low bits, so one shuffle hands a column's both over
  const int where = (((kSlabsPerCol * (w * 32 + lane) + q) * kSublanes + row)
                     * kLaneWidth) | (a & (kLaneWidth - 1));
  // the second: stage[n][lane] of every column n of the warp
  int32_t v[32];
#pragma unroll
  for (int c = 0; c < 32; ++c) {
    const int at = __shfl_sync(kAll, where, c);
    v[c] = tape[(at & ~(kLaneWidth - 1)) + ((lane - at) & (kLaneWidth - 1))];
  }
#pragma unroll
  for (int c = 0; c < 32; ++c) {
    const uint32_t u = (uint32_t)v[c];
    const int rank = (int)((v[c] < 0 ? 0u - u : u) & 7u);
    const uint32_t fetched = (uint32_t)__shfl_sync(kAll, v[c], rank);
    tile[w][lane][c] = fetched + u;
  }
  __syncwarp();
#pragma unroll 4
  for (int i = 0; i < kOutRows; ++i) {
    out[i * kCols + w * 32 + lane] = (int32_t)tile[w][i][lane];
  }
}

}  // namespace
}  // namespace picsong

// C entry point: tape (512, 8, 128), amt (128,), out (32, 128), all int32
// and contiguous. Launches on `stream`, does not synchronise, and returns
// cudaGetLastError().
extern "C" int picsong_probe2(const int32_t* tape, const int32_t* amt,
                              int32_t* out, void* stream) {
  picsong::probe2_kernel<<<1, picsong::kWarps * 32, 0,
                           static_cast<cudaStream_t>(stream)>>>(tape, amt,
                                                                out);
  return static_cast<int>(cudaGetLastError());
}
