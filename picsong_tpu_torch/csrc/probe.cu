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
// One CTA of 128 threads, thread n owning column n: it runs the 64-step
// accumulation for its 32 rows in registers and loads f[n] straight from
// tape[n][b + rank], the `stream[slot]` load of the BPC decoder. The
// window copy and the one-hot contraction worked around Mosaic's missing
// gather and have no counterpart. Row reads and output writes are
// coalesced across the CTA; the one gathered word per column is the only
// scattered access. What bounds it on this card: launch latency, the
// whole probe moves 32 KB.
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
constexpr int kSteps = 64;

__global__ void __launch_bounds__(kProbeCols)
probe_kernel(const int32_t* __restrict__ tape, const int32_t* __restrict__ base,
             int32_t* __restrict__ out) {
  const int n = threadIdx.x;
  uint32_t acc[kProbeRows];
#pragma unroll
  for (int r = 0; r < kProbeRows; ++r) {
    const int32_t v = tape[r * kProbeCap + n];
    const uint32_t step = (uint32_t)(v >> 1) + (v > 100 ? 1u : 0u);
    uint32_t a = 0;
#pragma unroll 1
    for (int i = 0; i < kSteps; ++i) a += step;
    acc[r] = a;
  }
  const int b = base[n] & ~(kWindow - 1);             // floor to 128
  const int rank = (int)(acc[0] & (kWindow - 1));      // floor mod 128
  const uint32_t f = (uint32_t)tape[n * kProbeCap + b + rank];
  const uint32_t row0 = base[0] > 0 ? 2u : 1u;
#pragma unroll
  for (int r = 0; r < kProbeRows; ++r) {
    uint32_t o = acc[r] + f;
    if (r == 0) o *= row0;
    out[r * kProbeCols + n] = (int32_t)o;
  }
}

}  // namespace
}  // namespace picsong

// C entry point: tape (128, 512), base (128,), out (32, 128), all int32 and
// contiguous. Launches on `stream`, does not synchronise, and returns
// cudaGetLastError().
extern "C" int picsong_probe(const int32_t* tape, const int32_t* base,
                             int32_t* out, void* stream) {
  picsong::probe_kernel<<<1, picsong::kProbeCols, 0,
                          static_cast<cudaStream_t>(stream)>>>(tape, base,
                                                               out);
  return static_cast<int>(cudaGetLastError());
}
