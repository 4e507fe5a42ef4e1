// BPC-PaCo encoder for Hopper (sm_90a), in three modes.
//
// Replaces the Pallas kernel `_make_encode_kernel`, launched by
// `_encode_chunks` (picsong_tpu/entropy/bpc_pallas.py:394), together with
// its XLA preparation and scatter post-pass (`_prepare_and_encode`,
// :434-478): mode cp2. Modes cp3 and bulk replace the XLA programs the JAX
// package runs for cp=3 and k > 0 (picsong_tpu/entropy/bpc_jax.py:
// `_spp_row_body` with three_cp :307-357, `_cp_row_body` :450-488,
// `_bulk_pass` :537-639, scheduled by `encode_blocks` :665-766). One warp
// per codeblock, one CTA of 32 threads per warp, so the grid is the batch
// of codeblocks. Each CTA: loads its block as sign-magnitude words into
// the shared column grids, finds the MSB with a warp OR, stages its
// probability table, codes every bitplane from its own MSB down, and
// writes each codeword straight to streams[blk][slot]:
// - cp2: SPP then MRP per plane, 64 rows x 2 phases each;
// - cp3: every word carries the candidate bit 30 from the start; per
//   plane SPP (only cells with a significant neighbour; the others become
//   candidates) and MRP below the MSB, then the cleanup pass CP over the
//   candidates;
// - bulk (k > 0): SPP and MRP down to the split plane, then one scan in
//   which each cell codes all the planes below it in an inner loop.
// Finish order follows bpc_jax.py:756-765: the stream is pre-filled with
// -1, every lane stores `low` at its reserved slot (slot 0 for a lane that
// never reserved), then word 0 takes the MSB (32 when empty); a block whose
// size reaches 4096 becomes the lane-major raw copy.
//
// What bounds it on this card: one warp's dependency chain, not bytes or
// operations. A block reads 16 KB and writes 16 KB (1024 blocks: 33.6 MB,
// 10 us at 3.35 TB/s) and codes (MSB + 1) x 4096 cell-planes plus one sign
// per nonzero coefficient at about a dozen int32 operations each (18 us
// at 2048^2 wl=5 on 16.7 int32 Tops/s). But every step depends on the one
// before (the lane's interval, the block's slot counter, the grid), so a
// block is a chain of ~10^3-10^4 warp steps: measured on one H100, one
// block alone takes as long as 528 copies of it (`tools/kernel_ab.py
// --sweep`, PERF.md PR 4), and at 1024 blocks the kernel time is the
// longest block's chain; at 16384 blocks it is about that chain times the
// ~11 waves of resident CTAs.
// The design therefore keeps the whole chain on-chip and short: the grids
// in 17 KB of shared memory, the block's probabilities in at most 3.4 KB
// more, the coder state in registers, one ballot per coding step for the
// slot ranks, no staging of codewords (the Pallas kernel's event tape,
// staging windows, DMA semaphores and scatter post-pass existed only
// because Mosaic has no scatter), and two measures that shorten the step:
// - the coder step has no branch: selects and one predicated store, so a
//   step carries no divergence and reconvergence barrier (BSSY/BSYNC)
//   around its data-dependent conditions;
// - a sign step in which no lane turned significant reserves nothing and
//   changes nothing, so it is skipped on a warp vote; that removes most
//   sign steps of the high planes and of the bulk pass.
// Other designs were measured on one H100 and dropped (PERF.md PR 4):
// contexts from warp-uniform significance row masks with a symbol pass 8
// rows ahead of the coder (slower at 16384 blocks); the scan recording
// each lane's symbols for 32 steps, each lane then coding its own list
// and the slots assigned by one ballot per reserving step (2.4x slower:
// every symbol costs two dependent shared loads on the lane's chain, and
// the slot loop is serial); the grid's update moved ahead of the coder
// (cp2 4% faster, cp3 and bulk slower); and skipping MRP passes that code
// nothing (faster here, slower decoders). The mode is a template
// parameter, so the cp2 variant carries no test of the others.
#include "bpc_common.cuh"

namespace picsong {
namespace {

struct EncoderLane {
  int low = 0;
  int size = 0;
  int resv = 0;
};

__device__ __forceinline__ uint32_t to_word(int32_t v) {
  const uint32_t mag = v < 0 ? 0u - (uint32_t)v : (uint32_t)v;
  return (mag << 1) | (v < 0 ? 1u : 0u);
}

// One arithmetic-coder step for the whole warp (bpc_jax._ac_encode),
// without branches but the predicated codeword store.
__device__ __forceinline__ void ac_encode(EncoderLane& s, int& counter,
                                          bool active, int bit, int prob,
                                          int prec, int lane, int32_t* out) {
  const bool need = active && s.size == 0;
  const int slot = reserve(need, counter, lane);
  s.resv = need ? slot : s.resv;
  const int size = need ? kIntervalInit : s.size;
  const int low = need ? 0 : s.low;
  const int aux = ((size * prob) >> prec) + bit;
  const int nsize = bit ? size - aux : aux;
  s.low = active && bit ? low + aux : low;
  s.size = active ? nsize : size;
  if (active && nsize == 0) out[s.resv] = s.low;
}

struct Encoder {
  Grid& g;
  EncoderLane s;
  int counter;
  int prec;
  int lane;
  int32_t* out;

  __device__ __forceinline__ void code(bool active, int bit, int prob) {
    ac_encode(s, counter, active, bit, prob, prec, lane, out);
  }

  // Significance propagation. Phase 1 reads phase 0's updated even cells
  // of the same row, and the next row reads this row's updates: a
  // __syncwarp after each phase. With cp=3 only cells with a significant
  // neighbour are coded; an insignificant cell with none becomes a
  // cleanup-pass candidate.
  template <int CP>
  __device__ __forceinline__ void spp(const int* pp, int plane) {
    const uint32_t flag = kSigBit | ((uint32_t)plane << 24);
    for (int r = 0; r < kRows; ++r) {
      for (int phase = 0; phase < 2; ++phase) {
        const Neighborhood nb = neighbors(g, r, lane, phase);
        const bool insig = (nb.cur >> 31) == 0;
        const int ctx = sig_ctx(nb);
        const bool active = CP == 3 ? insig && ctx > 0 : insig;
        const int bit = magnitude_bit(nb.cur, plane);
        code(active, bit, pp[kSigRow + ctx]);
        // the sign step runs only after the significance step of all lanes
        const bool newly = active && bit;
        if (__any_sync(kFullMask, newly)) {
          const int sctx = sign_ctx(nb);
          const int ssym = ((int)(nb.cur & 1u) == (sctx & 1)) ? 0 : 1;
          code(newly, ssym, pp[kSignRow + (sctx >> 1)]);
        }
        if (newly) {
          *cell(g, r, lane, phase) = nb.cur | flag;
        } else if (CP == 3 && insig && ctx == 0) {
          *cell(g, r, lane, phase) = nb.cur | kCpBit;
        }
        __syncwarp();
      }
    }
  }

  // Magnitude refinement: each lane touches only its own cell.
  __device__ __forceinline__ void mrp(const int* pp, int plane) {
    const int ref_prob = pp[kRefRow];
    for (int r = 0; r < kRows; ++r) {
      for (int phase = 0; phase < 2; ++phase) {
        uint32_t* c = cell(g, r, lane, phase);
        const uint32_t cur = *c;
        const bool refine = (cur >> 29) & 1u;
        code(refine, magnitude_bit(cur, plane), ref_prob);
        if (!refine && (cur >> 31)) *c = cur | kRefBit;
      }
    }
  }

  // Cleanup pass (cp=3): codes the candidates with the cleanup
  // probabilities and clears their bit 30; a cell significant here also
  // takes bit 29, so it is refined from the next plane on.
  __device__ __forceinline__ void cp(const int* pp, int plane) {
    const uint32_t flag = kSigBit | kRefBit | ((uint32_t)plane << 24);
    for (int r = 0; r < kRows; ++r) {
      for (int phase = 0; phase < 2; ++phase) {
        const Neighborhood nb = neighbors(g, r, lane, phase);
        const bool active = (nb.cur >> 30) & 1u;
        const int bit = magnitude_bit(nb.cur, plane);
        code(active, bit, pp[kCpSigRow + sig_ctx(nb)]);
        const bool newly = active && bit;
        if (__any_sync(kFullMask, newly)) {
          const int sctx = sign_ctx(nb);
          const int ssym = ((int)(nb.cur & 1u) == (sctx & 1)) ? 0 : 1;
          code(newly, ssym, pp[kCpSignRow + (sctx >> 1)]);
        }
        if (active) {
          *cell(g, r, lane, phase) = (nb.cur & ~kCpBit) | (newly ? flag : 0u);
        }
        __syncwarp();
      }
    }
  }

  // Bulk pass (k > 0): per cell, planes entry down to 0 (at most n_planes
  // of them): refinement of a significant lane, else significance with
  // the context frozen at the entry plane, then the sign with the context
  // of that plane. Three warp-wide coding steps per plane, in this order.
  template <int S>
  __device__ __forceinline__ void bulk(const int* probs, int entry,
                                       int n_planes) {
    const int last = max(entry - n_planes + 1, 0);
    for (int r = 0; r < kRows; ++r) {
      for (int phase = 0; phase < 2; ++phase) {
        const Neighborhood nb = neighbors(g, r, lane, phase);
        const int ctx = entry != 0 ? sig_ctx_bulk(nb, entry) : sig_ctx(nb);
        uint32_t work = nb.cur;
        for (int plane = entry; plane >= last; --plane) {
          const int* pp = probs + plane * S;
          const bool sig = work >> 31;
          const int bit = magnitude_bit(work, plane);
          code(sig, bit, pp[kRefRow]);
          code(!sig, bit, pp[kSigRow + ctx]);
          const bool newly = !sig && bit;
          if (__any_sync(kFullMask, newly)) {
            const int sctx = sign_ctx(nb, plane);
            const int ssym = ((int)(work & 1u) == (sctx & 1)) ? 0 : 1;
            code(newly, ssym, pp[kSignRow + (sctx >> 1)]);
          }
          if (newly) work |= kSigBit | ((uint32_t)plane << 24);
        }
        *cell(g, r, lane, phase) = work;
        __syncwarp();
      }
    }
  }
};

template <int CP, bool BULK>
__global__ void __launch_bounds__(kLanes)
bpc_encode_kernel(const int32_t* __restrict__ blocks,
                  const int32_t* __restrict__ lut, int lut_len,
                  BlockMeta meta, int n_planes, int prec, int stride,
                  int32_t* __restrict__ streams,
                  int32_t* __restrict__ sizes) {
  constexpr int S = prob_stride<CP>();
  __shared__ Grid g;
  __shared__ int probs[kMaxPlanes * S];
  const int blk = blockIdx.x;
  const int lane = threadIdx.x;
  const int32_t* src = blocks + (size_t)blk * kBlockWords;
  int32_t* out = streams + (size_t)blk * kBlockWords;

  for (int i = lane; i < kGridCols; i += kLanes) {
    g.e[0][i] = g.e[kGridRows - 1][i] = 0;
    g.o[0][i] = g.o[kGridRows - 1][i] = 0;
  }
  for (int r = lane; r < kGridRows; r += kLanes) {
    g.e[r][kLanes] = 0;
    g.o[r][0] = 0;
  }
  // cp=3: every word starts as a candidate (bpc_jax.py:687-688)
  const uint32_t init = CP == 3 ? kCpBit : 0u;
  uint32_t mag_or = 0;
  for (int r = 0; r < kRows; ++r) {
    const int2 v = reinterpret_cast<const int2*>(src + r * kRows)[lane];
    const uint32_t w0 = to_word(v.x) | init, w1 = to_word(v.y) | init;
    g.e[r + 1][lane] = w0;
    g.o[r + 1][lane + 1] = w1;
    mag_or |= (w0 | w1) >> 1;
  }
  const int4 fill = make_int4(-1, -1, -1, -1);
  for (int i = lane; i < kBlockWords / 4; i += kLanes) {
    reinterpret_cast<int4*>(out)[i] = fill;
  }
  mag_or = __reduce_or_sync(kFullMask, mag_or);
  // findMSB3CP: `>> 1` moved the candidate bit to bit 29
  if (CP == 3) mag_or &= ~kRefBit;
  const int msb = mag_or ? 31 - __clz(mag_or) : -1;
  __syncwarp();
  const int consec = stage_block<CP, BULK>(probs, lut, lut_len, meta, blk,
                                           msb, stride, lane);

  Encoder enc{g, EncoderLane{}, 0, prec, lane, out};
  // Planes above a block's MSB are fully inactive, so starting at the MSB
  // gives the bytes of a loop from n_planes - 1. With k > 0 the normal
  // passes stop at the split plane.
  for (int plane = min(msb, n_planes - 1); plane >= (BULK ? consec : 0);
       --plane) {
    const int* pp = probs + plane * S;
    // cp=3: the MSB plane runs CP alone
    if (CP == 2 || plane < msb) {
      enc.spp<CP>(pp, plane);
      enc.mrp(pp, plane);
    }
    if (CP == 3) enc.cp(pp, plane);
  }
  if (BULK) {
    const int entry = bulk_entry(msb, consec);
    if (entry >= 0) enc.bulk<S>(probs, entry, n_planes);
  }

  __syncwarp();
  out[enc.s.resv] = enc.s.low;
  __syncwarp();
  const int size = msb < 0 ? 1 : enc.counter + 1;
  if (size == kBlockWords) {
    // raw copy: out[lane*128 + row*2 + parity] = word[row][2 lane + parity]
    int2* raw = reinterpret_cast<int2*>(out + lane * 2 * kRows);
    for (int r = 0; r < kRows; ++r) {
      raw[r] = make_int2((int)(g.e[r + 1][lane] & 0xFFFFu),
                         (int)(g.o[r + 1][lane + 1] & 0xFFFFu));
    }
  } else if (lane == 0) {
    out[0] = msb < 0 ? 32 : msb;
  }
  if (lane == 0) sizes[blk] = size;
}

template <int CP, bool BULK>
void launch(const int32_t* blocks, const int32_t* lut, int lut_len,
            const BlockMeta& meta, int n, int n_planes, int prec, int stride,
            int32_t* streams, int32_t* sizes, cudaStream_t stream) {
  bpc_encode_kernel<CP, BULK><<<n, kLanes, 0, stream>>>(
      blocks, lut, lut_len, meta, n_planes, prec, stride, streams, sizes);
}

}  // namespace
}  // namespace picsong

// C entry point: launches the variant of `mode` (picsong::Mode) on
// `stream`, does not synchronise, and returns cudaGetLastError() so that a
// refused launch is reported to the caller.
extern "C" int picsong_bpc_encode(const int32_t* blocks, const int32_t* lut,
                                  int lut_len, const int32_t* ref_base,
                                  const int32_t* sig_base,
                                  const int32_t* sign_base,
                                  const int32_t* cp_sig_base,
                                  const int32_t* cp_sign_base,
                                  const float* k_over_l2, int n, int n_planes,
                                  int prec, int stride, int mode,
                                  int32_t* streams, int32_t* sizes,
                                  void* stream) {
  using namespace picsong;
  const BlockMeta meta{ref_base, sig_base, sign_base,
                       cp_sig_base, cp_sign_base, k_over_l2};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n > 0) {
    switch (mode) {
      case kModeCp2:
        launch<2, false>(blocks, lut, lut_len, meta, n, n_planes, prec,
                         stride, streams, sizes, s);
        break;
      case kModeCp3:
        launch<3, false>(blocks, lut, lut_len, meta, n, n_planes, prec,
                         stride, streams, sizes, s);
        break;
      case kModeBulk:
        launch<2, true>(blocks, lut, lut_len, meta, n, n_planes, prec,
                        stride, streams, sizes, s);
        break;
      default:
        return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* picsong_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
