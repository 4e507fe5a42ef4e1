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
// of codeblocks. Each CTA: loads its block, finds the MSB with a warp
// OR, stages its probability table, codes every bitplane from its own MSB
// down, and writes each codeword straight to streams[blk][slot]:
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
// What bounds it on this card: one warp's dependency chain and the
// instructions of its steps, not bytes or operations. A block reads 16 KB
// and writes 16 KB (1024 blocks: 33.6 MB, 10 us at 3.35 TB/s) and codes
// (MSB + 1) x 4096 cell-planes plus one sign per nonzero coefficient at
// about a dozen int32 operations each (18 us at 2048^2 wl=5 on 16.7 int32
// Tops/s). But every step depends on the one before (the lane's interval,
// the block's slot counter), so a block is a chain of ~10^3-10^4 warp
// steps: one block alone takes as long as 528 copies of it
// (`tools/kernel_ab.py --sweep`, PERF.md §6); at one wave the kernel
// time is the longest block's chain, and at 16384 blocks the steps of the
// CTAs resident on an SM share its issue slots, wave after wave. No
// codeword is staged (the Pallas kernel's event tape, staging windows, DMA
// semaphores and scatter post-pass existed only because Mosaic has no
// scatter), and the coder step has no branch but its predicated store.
//
// cp2, the main path's mode, runs MaskEncoder. In cp2 every symbol is a
// function of the magnitudes alone: a cell is significant before plane p
// when its magnitude has a bit above p (up to the top plane) and turns
// significant at p when it has bit p. So at block start a 32 x 32 bit
// transpose a 16 rows turns each lane's 128 words into its bit-planes (23
// planes of 4 words, 11.8 KB of shared memory a block, each word read by
// its own lane once a plane) and its sign mask; at each plane one shuffle
// each way and a few shifts make the 64-row masks of the four columns a
// context reads (the lane's two and the nearest of each neighbour lane),
// and a SPP step reads only registers and the probability table: a
// funnel shift of three masks, two logic operations and a popcount for
// the context, and the branch-free packed table of bpc_common.cuh for the
// sign. The sign step and the MRP steps run on warp-uniform row masks made
// by a warp OR a plane, so no step votes, stores a cell or ends in a
// __syncwarp, and an MRP step that no lane codes, which reserves nothing,
// is skipped; the kernel adds its steps in scope and those skipped to two
// counters (`counts`, may be null), as the decoder does.
// cp3 and bulk keep the grid encoder (Encoder): their contexts read the
// cleanup candidates and the plane at which a neighbour turned
// significant, which the masks do not carry. Its words live in the shared
// column grids of bpc_common.cuh (17 KB), a step loads its neighbourhood,
// stores its cell and ends in a __syncwarp, and a sign step in which no
// lane turned significant is skipped on a warp vote.
// Other designs were measured on one H100 and dropped (PERF.md §6). First:
// contexts from warp-uniform significance row masks with a symbol pass 8
// rows ahead of the coder (slower at 16384 blocks); the scan recording
// each lane's symbols for 32 steps, each lane then coding its own list
// and the slots assigned by one ballot per reserving step (2.4x slower:
// every symbol costs two dependent shared loads on the lane's chain, and
// the slot loop is serial); the grid's update moved ahead of the coder.
// Then, against the cp2 kernel kept: the block's words kept in
// shared memory and a plane's bits gathered from them at each plane (4.8%
// slower at 16384 blocks, 1.1% at 1280: 64 loads and 128 bit moves a
// plane, and 16 KB of shared memory); the SPP's row loop unrolled twice
// (23% and 9% slower); its loop over groups of 8 rows rolled, the masks'
// words moved along register queues (no faster, 107 registers). The mode
// is a template parameter, so the cp2 variant carries no test of the
// others.
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

// Bit i of a[j] becomes bit j of a[i]: a 32 x 32 bit transpose in
// registers, five rounds that swap the off-diagonal blocks of 16, 8, 4, 2
// and 1 bits.
__device__ __forceinline__ void transpose32(uint32_t a[32]) {
#pragma unroll
  for (int round = 0; round < 5; ++round) {
    const int j = 16 >> round;
    const uint32_t m = round == 0   ? 0x0000FFFFu
                       : round == 1 ? 0x00FF00FFu
                       : round == 2 ? 0x0F0F0F0Fu
                       : round == 3 ? 0x33333333u
                                    : 0x55555555u;
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const int k = (i / j) * 2 * j + i % j;
      const uint32_t t = ((a[k] >> j) ^ a[k + j]) & m;
      a[k] ^= t << j;
      a[k + j] ^= t;
    }
  }
}

// The planes of a magnitude that the cp2 encoder keeps: a word's magnitude
// has 23 bits (spec.MAGNITUDE_MASK); it reads the bits of a larger one,
// which the word's flags would overwrite in the grid encoder, as 0.
constexpr int kMaskPlanes = 23;

// The 8 rows 8h..8h+7 of a two-column word (bit 2i + c: row i, column c)
// spread to the low two bits of a 4-bit group a row.
template <int H>
__device__ __forceinline__ uint32_t spread_rows(uint32_t w) {
  uint32_t x = __byte_perm(w, 0u, H == 0 ? 0x4140 : 0x4342);
  x = (x | (x << 4)) & 0x0F0F0F0Fu;
  return (x | (x << 2)) & 0x33333333u;
}

// The four columns a cp2 context reads, from a lane's two-column words
// `own` (rows 16j..16j+15 in word j) and its neighbour lanes' (by one
// shuffle each way): a 4-bit group a row, bit 0 column 2 lane, 1 column
// 2 lane + 1, 2 column 2 lane - 1, 3 column 2 lane + 2, and the whole
// shifted up by a row: bit 4 (r + 1) + k of `x` is row r, rows -1 and 64
// are zero. Bits 4r..4r+11 are then rows r-1, r, r+1.
__device__ __forceinline__ void four_columns(const uint32_t own[4], int lane,
                                             uint32_t x[9]) {
  uint32_t prev = 0;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const uint32_t l = __shfl_up_sync(kFullMask, own[j], 1);
    const uint32_t r = __shfl_down_sync(kFullMask, own[j], 1);
    // lane l-1's odd column and lane l+1's even column, a 2-bit group a row
    const uint32_t side = (lane == 0 ? 0u : (l >> 1) & 0x55555555u) |
                          (lane == kLanes - 1 ? 0u : (r << 1) & 0xAAAAAAAAu);
    const uint32_t m0 = spread_rows<0>(own[j]) | (spread_rows<0>(side) << 2);
    const uint32_t m1 = spread_rows<1>(own[j]) | (spread_rows<1>(side) << 2);
    x[2 * j] = __funnelshift_l(prev, m0, 4);
    x[2 * j + 1] = __funnelshift_l(m0, m1, 4);
    prev = m1;
  }
  x[8] = prev >> 28;
}

// The 12-bit window of rows r-1, r, r+1 (four_columns' bits) that a cell
// of phase P reads: its 8 neighbours, and those scanned before it in the
// plane's SPP, whose state is after their step (row r-1; at phase 1 also
// row r). Its sign neighbours, left and right, above and below.
template <int P>
struct Window {
  static constexpr uint32_t kCell = 0x10u << P;
  static constexpr uint32_t kNeighbours = P == 0 ? 0x767u : 0xB9Bu;
  static constexpr uint32_t kScanned = P == 0 ? 0x00Fu : 0x0FFu;
  static constexpr uint32_t kHorizontal = P == 0 ? 0x060u : 0x090u;
  static constexpr uint32_t kVertical = P == 0 ? 0x101u : 0x202u;
};

// The cp2 encoder (mode kModeCp2) on lane-owned column bitmasks; see the
// note at the head of this file. Every symbol it codes is a function of
// the magnitudes: a cell is significant before plane p when its magnitude
// has a bit above p (up to the top plane) and turns significant at p when
// it has bit p. So the masks come from the block's bit-planes, built once
// at block start (`load`), and no coder step reads or writes shared state.
// Two-column words hold a lane's columns 2 lane and 2 lane + 1, rows
// 16j..16j+15 in word j, bit 2i + c row 16j + i and column 2 lane + c;
// four-column words are four_columns' windows.
struct MaskEncoder {
  EncoderLane s;
  int counter;
  int prec;
  int lane;
  int32_t* out;
  uint32_t* sliced;  // [plane][j][lane]: the lane's words of bit plane p
  uint32_t sig[4] = {};   // its cells significant before the plane
  uint32_t sig4[9] = {};  // the same, four columns
  uint32_t neg4[9];       // negative cells, four columns

  __device__ __forceinline__ void code(bool active, int bit, int prob) {
    ac_encode(s, counter, active, bit, prob, prec, lane, out);
  }

  // Reads the block, keeps its bit-planes in `sliced` and its signs in
  // neg4; returns its MSB (-1 when empty). A transpose of the 32 words of
  // 16 rows makes word p + 1 the rows' magnitude bits p and word 0 their
  // signs.
  __device__ __forceinline__ int load(const int32_t* src) {
    uint32_t mag_or = 0;
    uint32_t neg[4] = {0u, 0u, 0u, 0u};
#pragma unroll 1
    for (int j = 0; j < 4; ++j) {
      uint32_t a[32];
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        const int2 v =
            reinterpret_cast<const int2*>(src + (16 * j + i) * kRows)[lane];
        a[2 * i] = to_word(v.x);
        a[2 * i + 1] = to_word(v.y);
        mag_or |= a[2 * i] | a[2 * i + 1];
      }
      transpose32(a);
#pragma unroll
      for (int p = 0; p < kMaskPlanes; ++p) {
        sliced[(4 * p + j) * kLanes + lane] = a[p + 1];
      }
#pragma unroll
      for (int k = 0; k < 3; ++k) neg[k] = neg[k + 1];
      neg[3] = a[0];
    }
    four_columns(neg, lane, neg4);
    mag_or = __reduce_or_sync(kFullMask, mag_or >> 1);
    return mag_or ? 31 - __clz(mag_or) : -1;
  }

  // The SPP step of the cell of phase P in the row whose windows are `sig_w`
  // (before the plane), `bit_w` (its bit p) and `neg_w`; with `signs`, some
  // lane turns significant at this step and the sign step runs.
  template <int P>
  __device__ __forceinline__ void spp_step(uint32_t sig_w, uint32_t bit_w,
                                           uint32_t neg_w, bool signs,
                                           const int* pp,
                                           const SignProbs& sign_probs) {
    using W = Window<P>;
    const uint32_t nb =
        (sig_w | (bit_w & W::kScanned)) & W::kNeighbours;
    const bool insig = (sig_w & W::kCell) == 0;
    const int bit = (bit_w & W::kCell) ? 1 : 0;
    code(insig, bit, pp[kSigRow + __popc(nb)]);
    if (signs) {
      const int sctx = sign_context<W::kHorizontal, W::kVertical>(
          nb & ~neg_w, nb & neg_w);
      const int ssym = ((neg_w & W::kCell) ? 1 : 0) ^ (sctx & 1);
      code(insig && bit, ssym, sign_probs.at(sctx >> 1));
    }
  }

  // SPP over the 64 rows, 8 at a time: `bit4` is the plane's four-column
  // bit mask, `turned` the rows where some lane turns significant (bit
  // 2i + P of word j: row 16j + i, phase P; warp-uniform).
  __device__ __forceinline__ void spp(const int* pp, const uint32_t bit4[9],
                                      const uint32_t turned[4]) {
    const SignProbs sign_probs{pp[kSignRow], pp[kSignRow + 1],
                               pp[kSignRow + 2], pp[kSignRow + 3]};
#pragma unroll
    for (int g = 0; g < 8; ++g) {
      const uint32_t signs = turned[g >> 1] >> (16 * (g & 1));
#pragma unroll 1
      for (int i = 0; i < 8; ++i) {
        const int shift = 4 * i;
        const uint32_t sig_w = __funnelshift_r(sig4[g], sig4[g + 1], shift);
        const uint32_t bit_w = __funnelshift_r(bit4[g], bit4[g + 1], shift);
        const uint32_t neg_w = __funnelshift_r(neg4[g], neg4[g + 1], shift);
        const uint32_t row = signs >> (2 * i);
        spp_step<0>(sig_w, bit_w, neg_w, row & 1u, pp, sign_probs);
        spp_step<1>(sig_w, bit_w, neg_w, row & 2u, pp, sign_probs);
      }
    }
  }

  // MRP: only the (row, phase) steps in `refine` (warp-uniform, bits as
  // `turned`), in scan order; the cell refines when significant before the
  // plane and codes its bit p.
  __device__ __forceinline__ void mrp(int prob, const uint32_t refine[4],
                                      const uint32_t bit[4]) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      for (uint32_t steps = refine[j]; steps != 0; steps &= steps - 1) {
        const int i = __ffs(steps) - 1;
        code((sig[j] >> i) & 1u, (bit[j] >> i) & 1u, prob);
      }
    }
  }

  // Planes `top` down to 0; returns the MRP steps skipped.
  __device__ __forceinline__ int planes(const int* probs, int top) {
    int skipped = 0;
    for (int plane = top; plane >= 0; --plane) {
      const int* pp = probs + plane * prob_stride<2>();
      uint32_t bit[4], turned[4], refine[4], bit4[9];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        bit[j] = plane < kMaskPlanes
                     ? sliced[(4 * plane + j) * kLanes + lane] : 0u;
        turned[j] = __reduce_or_sync(kFullMask, bit[j] & ~sig[j]);
        refine[j] = __reduce_or_sync(kFullMask, sig[j]);
      }
      four_columns(bit, lane, bit4);
      spp(pp, bit4, turned);
      mrp(pp[kRefRow], refine, bit);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        sig[j] |= bit[j];
        skipped += 2 * 16 - __popc(refine[j]);
      }
#pragma unroll
      for (int k = 0; k < 9; ++k) sig4[k] |= bit4[k];
    }
    return skipped;
  }
};

// Pre-fills a block's stream with -1 (bpc_jax.py:756).
__device__ __forceinline__ void fill_stream(int32_t* out, int lane) {
  const int4 fill = make_int4(-1, -1, -1, -1);
  for (int i = lane; i < kBlockWords / 4; i += kLanes) {
    reinterpret_cast<int4*>(out)[i] = fill;
  }
}

// The end of a block's stream (bpc_jax.py:756-765): every lane stores
// `low` at its reserved slot (slot 0 for a lane that never reserved), then
// word 0 takes the MSB (32 when empty); a block whose size reaches 4096
// becomes the lane-major raw copy of the low 16 bits of its words,
// `words(r)` the lane's two of row r. Returns the size.
template <class Words>
__device__ __forceinline__ int finish(const EncoderLane& s, int counter,
                                      int msb, int32_t* out, int lane,
                                      const Words& words) {
  __syncwarp();
  out[s.resv] = s.low;
  __syncwarp();
  const int size = msb < 0 ? 1 : counter + 1;
  if (size == kBlockWords) {
    // raw copy: out[lane*128 + row*2 + parity] = word[row][2 lane + parity]
    int2* raw = reinterpret_cast<int2*>(out + lane * 2 * kRows);
    for (int r = 0; r < kRows; ++r) {
      const uint2 w = words(r);
      raw[r] = make_int2((int)(w.x & 0xFFFFu), (int)(w.y & 0xFFFFu));
    }
  } else if (lane == 0) {
    out[0] = msb < 0 ? 32 : msb;
  }
  return size;
}

template <int CP, bool BULK>
__global__ void __launch_bounds__(kLanes)
bpc_encode_kernel(const int32_t* __restrict__ blocks,
                  const int32_t* __restrict__ lut, int lut_len,
                  BlockMeta meta, int n_planes, int prec, int stride,
                  int32_t* __restrict__ streams,
                  int32_t* __restrict__ sizes,
                  unsigned long long* __restrict__ counts) {
  constexpr int S = prob_stride<CP>();
  __shared__ int probs[kMaxPlanes * S];
  const int blk = blockIdx.x;
  const int lane = threadIdx.x;
  const int32_t* src = blocks + (size_t)blk * kBlockWords;
  int32_t* out = streams + (size_t)blk * kBlockWords;

  int size;
  if constexpr (CP == 2 && !BULK) {
    __shared__ uint32_t sliced[kMaskPlanes * 4 * kLanes];
    MaskEncoder enc{EncoderLane{}, 0, prec, lane, out, sliced};
    const int msb = enc.load(src);
    fill_stream(out, lane);
    __syncwarp();
    stage_block<CP, BULK>(probs, lut, lut_len, meta, blk, msb, stride, lane);
    // Planes above a block's MSB are fully inactive, so starting at the MSB
    // gives the bytes of a loop from n_planes - 1.
    const int top = min(msb, n_planes - 1);
    const int skipped = enc.planes(probs, top);
    // the grid is gone: a raw copy reads the block again
    size = finish(enc.s, enc.counter, msb, out, lane, [&](int r) {
      const int2 v = reinterpret_cast<const int2*>(src + r * kRows)[lane];
      return make_uint2(to_word(v.x), to_word(v.y));
    });
    // the steps of the streams that are not raw copies, as the decoder's
    if (counts != nullptr && lane == 0 && top >= 0 && size != kBlockWords) {
      atomicAdd(&counts[0], (unsigned long long)(4 * kRows * (top + 1)));
      atomicAdd(&counts[1], (unsigned long long)skipped);
    }
  } else {
    __shared__ Grid g;
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
    fill_stream(out, lane);
    mag_or = __reduce_or_sync(kFullMask, mag_or);
    // findMSB3CP: `>> 1` moved the candidate bit to bit 29
    if (CP == 3) mag_or &= ~kRefBit;
    const int msb = mag_or ? 31 - __clz(mag_or) : -1;
    __syncwarp();
    const int consec = stage_block<CP, BULK>(probs, lut, lut_len, meta, blk,
                                             msb, stride, lane);

    Encoder enc{g, EncoderLane{}, 0, prec, lane, out};
    // With k > 0 the normal passes stop at the split plane.
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
    size = finish(enc.s, enc.counter, msb, out, lane, [&](int r) {
      return make_uint2(g.e[r + 1][lane], g.o[r + 1][lane + 1]);
    });
  }
  if (lane == 0) sizes[blk] = size;
}

template <int CP, bool BULK>
void launch(const int32_t* blocks, const int32_t* lut, int lut_len,
            const BlockMeta& meta, int n, int n_planes, int prec, int stride,
            int32_t* streams, int32_t* sizes, unsigned long long* counts,
            cudaStream_t stream) {
  bpc_encode_kernel<CP, BULK><<<n, kLanes, 0, stream>>>(
      blocks, lut, lut_len, meta, n_planes, prec, stride, streams, sizes,
      counts);
}

}  // namespace
}  // namespace picsong

// C entry point: launches the variant of `mode` (picsong::Mode) on
// `stream`, does not synchronise, and returns cudaGetLastError() so that a
// refused launch is reported to the caller. The cp2 variant adds its steps
// in scope and its skipped steps to counts[0] and counts[1] (int64 on the
// device; null counts nothing).
extern "C" int picsong_bpc_encode(const int32_t* blocks, const int32_t* lut,
                                  int lut_len, const int32_t* ref_base,
                                  const int32_t* sig_base,
                                  const int32_t* sign_base,
                                  const int32_t* cp_sig_base,
                                  const int32_t* cp_sign_base,
                                  const float* k_over_l2, int n, int n_planes,
                                  int prec, int stride, int mode,
                                  int32_t* streams, int32_t* sizes,
                                  long long* counts, void* stream) {
  using namespace picsong;
  const BlockMeta meta{ref_base, sig_base, sign_base,
                       cp_sig_base, cp_sign_base, k_over_l2};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  unsigned long long* c = reinterpret_cast<unsigned long long*>(counts);
  if (n > 0) {
    switch (mode) {
      case kModeCp2:
        launch<2, false>(blocks, lut, lut_len, meta, n, n_planes, prec,
                         stride, streams, sizes, c, s);
        break;
      case kModeCp3:
        launch<3, false>(blocks, lut, lut_len, meta, n, n_planes, prec,
                         stride, streams, sizes, c, s);
        break;
      case kModeBulk:
        launch<2, true>(blocks, lut, lut_len, meta, n, n_planes, prec,
                        stride, streams, sizes, c, s);
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
