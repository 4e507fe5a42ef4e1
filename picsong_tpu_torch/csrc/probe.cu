// The window-refill probe for Hopper (sm_90a).
//
// Replaces the Pallas kernel `kernel` of tools/pallas_probe.py (launched by
// `run`, pallas_call at l.58), a probe of the primitives the Pallas BPC
// coder leans on: a loop-carried vector accumulation, a per-column
// 128-aligned window refill, a one-hot fetch from the window and a
// conditional row update. With v = tape[0:32, 0:128] (int32, wrapping):
//   acc    = 64 * ((v >> 1) + (v > 100))       64 accumulation steps
//   b[n]   = floor(base[n] / 128) * 128
//   f[n]   = tape[n][b[n] + (acc[0][n] mod 128)]
//   out    = acc + f[None, :], row 0 doubled when base[0] > 0
//
// What bounds it on this card: latency. The whole probe moves 32 KB, so
// its time is the chain of dependent memory round trips after the launch,
// and the design keeps that chain at two: every load that depends on
// nothing (row 0's and base's words of a lane's columns, base[0], the
// warp's rows) goes out first, all together; the gather, which needs row
// 0 and base, goes out as soon as they are in; then the stores. The 64
// wrapping adds of a step are one shift, step << 6 (equal mod 2^32), so
// no loop stands between the loads and the gather.
//
// One CTA of four warps: warp w owns rows 8w .. 8w + 7, lane i columns
// 4i .. 4i + 3, so every row load and output store moves 16 bytes a lane
// and 512 bytes a warp (kVec; a variant moves words instead, for a tape,
// base or out that is not 16-byte aligned, a view of a larger buffer). Every warp needs the gathered words of all 128
// columns; it computes them itself (4 gathers a lane, the `stream[slot]`
// load of the BPC decoder) rather than share them through a barrier. The
// window copy and the one-hot contraction worked around Mosaic's missing
// gather and have no counterpart.
//
// Arithmetic is uint32 so that overflow wraps as in JAX; `acc mod 128` is
// `acc & 127`, the floor modulus of jnp. The wrapper guarantees base in
// [0, 512), where the window stays inside the tape row.
#include <cstdint>
#include <cuda_runtime.h>

namespace picsong {
namespace {

constexpr int kProbeCols = 128;   // codeblock chunk C
constexpr int kProbeRows = 32;
constexpr int kProbeCap = 512;    // tape row length CAP
constexpr int kWindow = 128;      // refill window, 128-aligned
constexpr int kStepShift = 6;     // 64 accumulation steps
constexpr int kWarps = 4;
constexpr int kWarpRows = kProbeRows / kWarps;
constexpr int kLaneCols = 4;      // one 16-byte vector
static_assert(kLaneCols * 32 == kProbeCols, "a warp spans the columns");

__device__ __forceinline__ uint32_t accumulated(int32_t v) {
  const uint32_t step = (uint32_t)(v >> 1) + (v > 100 ? 1u : 0u);
  return step << kStepShift;
}

__device__ __forceinline__ int32_t lane_word(const int4& x, int k) {
  return k == 0 ? x.x : k == 1 ? x.y : k == 2 ? x.z : x.w;
}

template <bool kVec>
__device__ __forceinline__ int4 load4(const int32_t* p) {
  if constexpr (kVec) return *reinterpret_cast<const int4*>(p);
  else return make_int4(p[0], p[1], p[2], p[3]);
}

template <bool kVec>
__device__ __forceinline__ void store4(int32_t* p, const int4& x) {
  if constexpr (kVec) {
    *reinterpret_cast<int4*>(p) = x;
  } else {
    p[0] = x.x; p[1] = x.y; p[2] = x.z; p[3] = x.w;
  }
}

// One CTA a launch: the bound of one block an SM lets ptxas spend the
// registers that keep every independent load in flight (without it, it
// held the kernel to 32 registers and sank four row loads below the first
// stores, a third round trip).
template <bool kVec>
__global__ void __launch_bounds__(kWarps * 32, 1)
probe_kernel(const int32_t* __restrict__ tape, const int32_t* __restrict__ base,
             int32_t* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const int w = threadIdx.x >> 5;
  const int n0 = lane * kLaneCols;
  // every independent load in flight together
  const int4 first = load4<kVec>(tape + n0);
  const int4 b = load4<kVec>(base + n0);
  const int32_t b0 = base[0];
  int4 rows[kWarpRows];
#pragma unroll
  for (int r = 0; r < kWarpRows; ++r) {
    rows[r] = load4<kVec>(tape + (w * kWarpRows + r) * kProbeCap + n0);
  }
  // the second round trip: the lane's four gathered words
  uint32_t f[kLaneCols];
#pragma unroll
  for (int k = 0; k < kLaneCols; ++k) {
    const int win = lane_word(b, k) & ~(kWindow - 1);            // floor
    const int rank = (int)(accumulated(lane_word(first, k))
                           & (kWindow - 1));                      // mod 128
    f[k] = (uint32_t)tape[(n0 + k) * kProbeCap + win + rank];
  }
  const uint32_t row0 = b0 > 0 ? 2u : 1u;
#pragma unroll
  for (int r = 0; r < kWarpRows; ++r) {
    uint32_t o[kLaneCols];
#pragma unroll
    for (int k = 0; k < kLaneCols; ++k) {
      o[k] = accumulated(lane_word(rows[r], k)) + f[k];
      if (w == 0 && r == 0) o[k] *= row0;
    }
    store4<kVec>(out + (w * kWarpRows + r) * kProbeCols + n0,
                 make_int4((int32_t)o[0], (int32_t)o[1], (int32_t)o[2],
                           (int32_t)o[3]));
  }
}

}  // namespace
}  // namespace picsong

// C entry point: tape (128, 512), base (128,), out (32, 128), all int32
// and contiguous; 16-byte vectors where all three are 16-byte aligned,
// else words. Launches on `stream`, does not synchronise, and returns
// cudaGetLastError().
extern "C" int picsong_probe(const int32_t* tape, const int32_t* base,
                             int32_t* out, void* stream) {
  const bool vec = ((reinterpret_cast<uintptr_t>(tape)
                     | reinterpret_cast<uintptr_t>(base)
                     | reinterpret_cast<uintptr_t>(out)) & 15) == 0;
  auto* kernel = vec ? picsong::probe_kernel<true>
                     : picsong::probe_kernel<false>;
  kernel<<<1, picsong::kWarps * 32, 0, static_cast<cudaStream_t>(stream)>>>(
      tape, base, out);
  return static_cast<int>(cudaGetLastError());
}
