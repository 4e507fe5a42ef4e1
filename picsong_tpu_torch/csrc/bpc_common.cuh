// BPC-PaCo on Hopper: what the encode and decode kernels share.
//
// One warp codes one 64x64 codeblock, the reference coder's own mapping:
// lane l owns columns 2l and 2l+1 and runs one 16-bit arithmetic coder.
// The codeblock's coefficient words live in shared memory as two column
// grids with a zero border (the layout of bpc_jax._to_grids), so that
// every neighbour read of a 32-lane step is one conflict-free row access:
//   e[1 + r][l]     = word[r][2l]       (column 32 is border)
//   o[1 + r][l + 1] = word[r][2l + 1]   (column 0 is border)
// A word is (|v| << 1) | sign in bits 0-23, the plane at which it became
// significant in bits 24-28, refinement in bit 29, the cleanup-pass
// candidate (cp=3) in bit 30, significance in bit 31
// (picsong_tpu_torch/core/spec.py).
//
// Three modes, each a template instantiation of both kernels: cp=2 k=0
// (SPP, MRP), cp=3 (SPP, MRP, CP) and cp=2 with k > 0 (SPP, MRP down to
// the split plane, then the fused multi-bitplane bulk pass).
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace picsong {

constexpr int kLanes = 32;
constexpr int kRows = 64;
constexpr int kGridRows = kRows + 2;
constexpr int kGridCols = kLanes + 1;
constexpr int kBlockWords = 4096;
constexpr int kMaxReservedSlot = 4094;   // spec.MAX_RESERVED_SLOT
constexpr int kMaxSlotCount = 4095;      // spec.MAX_SLOT_COUNT
constexpr int kIntervalInit = 0xFFFF;    // spec.AC_INTERVAL_INIT
constexpr uint32_t kSigBit = 1u << 31;
constexpr uint32_t kCpBit = 1u << 30;
constexpr uint32_t kRefBit = 1u << 29;
constexpr unsigned kFullMask = 0xffffffffu;
constexpr int kMaxPlanes = 32;

// Modes, as the C entry points take them.
enum Mode { kModeCp2 = 0, kModeCp3 = 1, kModeBulk = 2 };

// Per-codeblock metadata (bpc_jax.encode_blocks's arguments): LUT group
// bases of the refinement, significance and sign sections and of the two
// cleanup-pass sections (cp=3), and k / L2 step (k > 0).
struct BlockMeta {
  const int32_t* ref;
  const int32_t* sig;
  const int32_t* sign;
  const int32_t* cp_sig;
  const int32_t* cp_sign;
  const float* k_over_l2;
};

struct Grid {
  uint32_t e[kGridRows][kGridCols];
  uint32_t o[kGridRows][kGridCols];
};

// The cell a lane owns at (row r, phase): phase 0 is the even column.
__device__ __forceinline__ uint32_t* cell(Grid& g, int r, int lane, int phase) {
  return phase == 0 ? &g.e[r + 1][lane] : &g.o[r + 1][lane + 1];
}

struct Neighborhood {
  uint32_t cur, ul, up, ur, lf, rt, bl, bt, br;
};

// The current cell and its 8 neighbours (bpc_jax._neighbors).
__device__ __forceinline__ Neighborhood neighbors(const Grid& g, int r, int l,
                                                  int phase) {
  Neighborhood n;
  if (phase == 0) {
    n.cur = g.e[r + 1][l];
    n.ul = g.o[r][l];     n.up = g.e[r][l];     n.ur = g.o[r][l + 1];
    n.lf = g.o[r + 1][l];                       n.rt = g.o[r + 1][l + 1];
    n.bl = g.o[r + 2][l]; n.bt = g.e[r + 2][l]; n.br = g.o[r + 2][l + 1];
  } else {
    n.cur = g.o[r + 1][l + 1];
    n.ul = g.e[r][l];     n.up = g.o[r][l + 1];     n.ur = g.e[r][l + 1];
    n.lf = g.e[r + 1][l];                           n.rt = g.e[r + 1][l + 1];
    n.bl = g.e[r + 2][l]; n.bt = g.o[r + 2][l + 1]; n.br = g.e[r + 2][l + 1];
  }
  return n;
}

// Significance context: how many of the 8 neighbours are significant.
__device__ __forceinline__ int sig_ctx(const Neighborhood& n) {
  return (n.ul >> 31) + (n.up >> 31) + (n.ur >> 31) + (n.lf >> 31) +
         (n.rt >> 31) + (n.bl >> 31) + (n.bt >> 31) + (n.br >> 31);
}

// Whether a word became significant at `plane` or above (bits 24-28).
__device__ __forceinline__ int at_or_above(uint32_t v, int plane) {
  return ((v >> 24) & 31u) >= (uint32_t)plane;
}

// The bulk pass's significance context: neighbours significant at or
// above the entry plane (bpc_jax._sig_ctx_bulk).
__device__ __forceinline__ int sig_ctx_bulk(const Neighborhood& n,
                                            int plane) {
  return at_or_above(n.ul, plane) + at_or_above(n.up, plane) +
         at_or_above(n.ur, plane) + at_or_above(n.lf, plane) +
         at_or_above(n.rt, plane) + at_or_above(n.bl, plane) +
         at_or_above(n.bt, plane) + at_or_above(n.br, plane);
}

__device__ __forceinline__ int sign_contrib(uint32_t v, int plane) {
  return ((v >> 31) && at_or_above(v, plane)) ? ((v & 1u) ? -1 : 1) : 0;
}

// Sign context code with the expected sign in bit 0
// (bpc_pallas._sign_ctx / _sign_ctx_table). With `plane` > 0, only
// neighbours significant at or above it count (bpc_jax._sign_ctx_bulk).
__device__ __forceinline__ int sign_ctx(const Neighborhood& n,
                                        int plane = 0) {
  const int h = sign_contrib(n.lf, plane) + sign_contrib(n.rt, plane);
  const int v = sign_contrib(n.up, plane) + sign_contrib(n.bt, plane);
  if (h == 0) return v > 0 ? 2 : (v < 0 ? 3 : 0);
  if (h > 0) return v == 0 ? 4 : (v > 0 ? 6 : 0);
  return v == 0 ? 5 : (v > 0 ? 1 : 7);
}

// The complexity-scalability split plane, max(floor(msb * k / L2), 0) in
// float32 as bpc_jax computes it (bpc_jax.py:698); __fmul_rn keeps the
// product a single rounded multiply that no contraction can change.
__device__ __forceinline__ int split_plane(int msb, float k_over_l2) {
  return max((int)floorf(__fmul_rn((float)msb, k_over_l2)), 0);
}

// The plane at which the bulk pass starts: one below the split plane, or
// the MSB when the split lies above it; -1 when there is no bulk pass
// (bpc_jax.py:749-751).
__device__ __forceinline__ int bulk_entry(int msb, int consec) {
  return consec > msb ? msb : min(consec, max(msb, 0)) - 1;
}

// Bit `plane` of a word's magnitude. Two shifts keep plane 31 defined.
__device__ __forceinline__ int magnitude_bit(uint32_t w, int plane) {
  return (int)((w >> plane) >> 1) & 1;
}

// Warp-collective slot reservation for the lanes with `need`, ascending by
// lane: slot = min(rank + counter, 4094) + 1, counter += popc, capped at
// 4095 (bpc_jax._ac_encode, BPCEngine.cu:378-383). `counter` is
// warp-uniform; every lane of the warp must call this.
__device__ __forceinline__ int reserve(bool need, int& counter, int lane) {
  const unsigned ballot = __ballot_sync(kFullMask, need);
  const int rank = __popc(ballot & ((1u << lane) - 1u));
  const int slot = min(rank + counter, kMaxReservedSlot) + 1;
  counter = min(counter + __popc(ballot), kMaxSlotCount);
  return slot;
}

// A block's probability table in shared memory, one row of prob_stride
// entries per plane: significance by context, sign by context,
// refinement, and with cp=3 the cleanup pass's significance and sign.
constexpr int kSigRow = 0;
constexpr int kSignRow = 9;
constexpr int kRefRow = 13;
constexpr int kCpSigRow = 14;
constexpr int kCpSignRow = 23;

template <int CP>
__host__ __device__ constexpr int prob_stride() {
  return CP == 3 ? 27 : 14;
}

// The warp stages the rows of planes 0..top once, at block start, each
// index clipped into the table (bpc_jax's prefetch, bpc_pallas._prob_tables);
// the bulk pass changes plane at every cell, so per-plane staging would
// not do.
template <int CP>
__device__ __forceinline__ void stage_probs(
    int* probs, const int32_t* __restrict__ lut, int lut_len, int ref_b,
    int sig_b, int sign_b, int cp_sig_b, int cp_sign_b, int top, int lane) {
  constexpr int S = prob_stride<CP>();
  for (int i = lane; i < (top + 1) * S; i += kLanes) {
    const int plane = i / S;
    const int j = i - plane * S;
    int idx;
    if (j < kSignRow) {
      idx = sig_b + plane * 9 + j;
    } else if (j < kRefRow) {
      idx = sign_b + plane * 4 + (j - kSignRow);
    } else if (j == kRefRow) {
      idx = ref_b + plane;
    } else if (j < kCpSignRow) {
      idx = cp_sig_b + plane * 9 + (j - kCpSigRow);
    } else {
      idx = cp_sign_b + plane * 4 + (j - kCpSignRow);
    }
    probs[i] = lut[min(max(idx, 0), lut_len - 1)];
  }
  __syncwarp();
}

// What a block codes: its MSB, split plane (k > 0) and probability table.
// Every value is uniform across the warp, and so is every loop bound.
template <int CP, bool BULK>
__device__ __forceinline__ int stage_block(int* probs, const int32_t* lut,
                                           int lut_len, const BlockMeta& m,
                                           int blk, int msb, int stride,
                                           int lane) {
  int consec = 0;
  int s_off = 0;
  if (BULK) {
    consec = split_plane(msb, m.k_over_l2[blk]);
    s_off = min(consec, max(msb, 0)) * stride;
  }
  if (msb >= 0) {
    stage_probs<CP>(probs, lut, lut_len, m.ref[blk] + s_off,
                    m.sig[blk] + s_off, m.sign[blk] + s_off,
                    CP == 3 ? m.cp_sig[blk] : 0, CP == 3 ? m.cp_sign[blk] : 0,
                    min(msb, kMaxPlanes - 1), lane);
  }
  return consec;
}

}  // namespace picsong
