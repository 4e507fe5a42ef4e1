// BPC-PaCo decoder for Hopper (sm_90a), in three modes.
//
// Replaces the Pallas kernel `_make_kernel`, launched by `_decode_chunks`
// (picsong_tpu/entropy/bpc_pallas.py:707), together with its XLA
// preparation and finish (`_prepare_and_decode`, :760-794): mode cp2.
// Modes cp3 and bulk replace the XLA programs the JAX package runs for
// cp=3 and k > 0 (picsong_tpu/entropy/bpc_jax.py: `_spp_row_body` with
// three_cp :307-357, `_cp_row_body` :450-488, `_bulk_pass` :537-639,
// scheduled by `decode_blocks` :769-853). One warp per codeblock, one CTA
// of 32 threads per warp; lane l owns columns 2l and 2l+1. Each CTA
// rebuilds its block's sign-magnitude words by replaying the encoder's
// scan (see bpc_encode.cu for the passes of each mode), reading a
// codeword of streams[blk] when a lane's interval empties, and writes the
// (64, 64) int32 coefficients. Raw blocks (sizes
// == 4096) are copied out of their lane-major layout and empty blocks
// (word 0 == 32) decode to zeros, as in the Pallas wrapper.
//
// What bounds it on this card: the latency and the instructions of each
// coder step on one warp's chain, not bytes or residency. A block reads 16
// KB and writes 16 KB, and unlike the encoder's chain the decoder's cannot
// be split: every context depends on the symbols decoded before it. At one
// wave of CTAs the kernel takes its longest block's chain under the
// issue of its SM's other warps (on an H100 one block alone took as long
// as 528 copies of it, `tools/kernel_ab.py --sweep`); at 16384 blocks the
// steps of 12 resident CTAs an SM share its issue slots. So the cp2
// variant, the main path's, shortens the chain and cuts the instructions
// of a step:
// - the state its contexts read lives in registers, as 64-row bitmasks of
//   significance and sign: each lane's two columns and the column of each
//   neighbour lane that its contexts read (MaskDecoder). A cell turns
//   significant only at its own SPP step, whose ballot of newly
//   significant lanes (the vote that gates the sign step anyway) and of
//   their signs tells the lanes beside it. A context is then a few bit
//   operations and a popcount, and the sign context a lookup in a packed
//   table, without a branch; no step loads a neighbour from shared memory
//   or ends in a __syncwarp, and shared memory holds only each cell's
//   magnitude and sign, touched by its own lane.
// - the codewords come from a ring of 64 shared words refilled from
//   registers loaded one refill ahead (StreamWindow), so no coder step
//   waits on device memory.
// - an MRP step (row, phase) with no cell significant before the plane's
//   SPP codes nothing, reserves no slot and changes no state: it is
//   skipped, on row masks from two warp reductions a plane, so the branch
//   is uniform. (Skipping the SPP steps whose 32 cells are all significant
//   as well, 0.3-0.7% of them in the benchmark's images, cost more than it
//   saved on an H100.) The kernel adds the steps in scope and those
//   skipped to two counters (`counts`, may be null).
// - the coder step has no branch but the predicated codeword load, and a
//   sign step without a newly significant lane is skipped on a vote (in
//   the bulk pass the vote cost more than it saved at 16384 blocks).
// cp3 and bulk keep the grid decoder: their contexts read the cleanup
// candidates and the plane each neighbour turned significant at, which
// the masks do not carry. Their words live in the shared column grids of
// bpc_common.cuh, with the state flags in bits 24-31.
// Codeword reads are data-dependent but sequential per block (slot =
// counter + rank); the Pallas kernel's tape slabs, fetch window, one-hot
// contraction and DMA semaphores worked around Mosaic's missing gather
// and have no counterpart: a lane loads stream[slot], or its word of the
// ring.
#include "bpc_common.cuh"

namespace picsong {
namespace {

struct DecoderLane {
  int low = 0;
  int size = 0;
  uint32_t cw = 0;
};

__device__ __forceinline__ int to_coeff(uint32_t w) {
  const int mag = (int)((w & 0xFFFFFFu) >> 1);
  return (w & 1u) ? -mag : mag;
}

// One arithmetic-decoder step for the whole warp (bpc_jax._ac_decode),
// without branches but the predicated codeword load from `cs`, the stream
// or a window of it. The codeword compare is unsigned: unwritten slots
// hold -1 = 0xFFFFFFFF.
template <class Words>
__device__ __forceinline__ int ac_decode(DecoderLane& s, int& counter,
                                         bool active, int prob, int prec,
                                         int lane, const Words& cs) {
  const bool need = active && s.size == 0;
  const int slot = reserve(need, counter, lane);
  if (need) s.cw = (uint32_t)cs[slot];
  const int size = need ? kIntervalInit : s.size;
  const int low = need ? 0 : s.low;
  const int aux = ((size * prob) >> prec) + 1;
  const int aux2 = low + aux;
  const bool one = active && s.cw >= (uint32_t)aux2;
  s.size = active ? (one ? size - aux : aux - 1) : size;
  s.low = one ? aux2 : low;
  return one ? 1 : 0;
}

// The decoder's approximation mask at a plane: 0x3 << p, or 0x2 at p == 0.
__device__ __forceinline__ uint32_t plane_mask(int plane) {
  return plane >= 1 ? 3u << plane : 2u;
}

// A decoded refinement bit and its midpoint below it; `pmask` is
// plane_mask(plane).
__device__ __forceinline__ uint32_t refined(uint32_t w, int sym, int plane,
                                           uint32_t pmask) {
  return (w & ~pmask) | (pmask & ((((uint32_t)sym << 1) + 1u) << plane));
}

struct Decoder {
  Grid& g;
  DecoderLane s;
  int counter;
  int prec;
  int lane;
  const int32_t* cs;

  __device__ __forceinline__ int code(bool active, int prob) {
    return ac_decode(s, counter, active, prob, prec, lane, cs);
  }

  // Sign of a newly significant lane: its sign bit joins `set`, the
  // plane's approximation bits and flags, worked out once per plane.
  __device__ __forceinline__ uint32_t sign(bool newly, const Neighborhood& nb,
                                           int sctx_plane,
                                           const int* sign_probs,
                                           uint32_t set) {
    const int sctx = sign_ctx(nb, sctx_plane);
    const int ssym = code(newly, sign_probs[sctx >> 1]);
    return set | (((ssym & 1) == (sctx & 1)) ? 0u : 1u);
  }

  // SPP (phase order and __syncwarp as in the encoder)
  template <int CP>
  __device__ __forceinline__ void spp(const int* pp, int plane) {
    const uint32_t set = plane_mask(plane) | kSigBit | ((uint32_t)plane << 24);
    for (int r = 0; r < kRows; ++r) {
      for (int phase = 0; phase < 2; ++phase) {
        const Neighborhood nb = neighbors(g, r, lane, phase);
        const bool insig = (nb.cur >> 31) == 0;
        const int ctx = sig_ctx(nb);
        const bool active = CP == 3 ? insig && ctx > 0 : insig;
        const int bit = code(active, pp[kSigRow + ctx]);
        const bool newly = active && bit;
        const uint32_t upd = __any_sync(kFullMask, newly)
                                 ? sign(newly, nb, 0, pp + kSignRow, set)
                                 : set;
        if (newly) {
          *cell(g, r, lane, phase) = nb.cur | upd;
        } else if (CP == 3 && insig && ctx == 0) {
          *cell(g, r, lane, phase) = nb.cur | kCpBit;
        }
        __syncwarp();
      }
    }
  }

  // MRP: refinement sets the plane's two reconstruction bits
  __device__ __forceinline__ void mrp(const int* pp, int plane) {
    const int ref_prob = pp[kRefRow];
    const uint32_t pmask = plane_mask(plane);
    for (int r = 0; r < kRows; ++r) {
      for (int phase = 0; phase < 2; ++phase) {
        uint32_t* c = cell(g, r, lane, phase);
        const uint32_t cur = *c;
        const bool refine = (cur >> 29) & 1u;
        const int sym = code(refine, ref_prob);
        uint32_t upd = cur;
        if (refine) {
          upd = refined(cur, sym, plane, pmask);
        } else if (cur >> 31) {
          upd = cur | kRefBit;
        }
        *c = upd;
      }
    }
  }

  // Cleanup pass (cp=3), as in the encoder
  __device__ __forceinline__ void cp(const int* pp, int plane) {
    const uint32_t set =
        plane_mask(plane) | kSigBit | kRefBit | ((uint32_t)plane << 24);
    for (int r = 0; r < kRows; ++r) {
      for (int phase = 0; phase < 2; ++phase) {
        const Neighborhood nb = neighbors(g, r, lane, phase);
        const bool active = (nb.cur >> 30) & 1u;
        const int bit = code(active, pp[kCpSigRow + sig_ctx(nb)]);
        const bool newly = active && bit;
        const uint32_t upd = __any_sync(kFullMask, newly)
                                 ? sign(newly, nb, 0, pp + kCpSignRow, set)
                                 : set;
        if (active) {
          *cell(g, r, lane, phase) = (nb.cur & ~kCpBit) | (newly ? upd : 0u);
        }
        __syncwarp();
      }
    }
  }

  // Bulk pass (k > 0), as in the encoder. A plane past the staged table
  // can come only from a corrupt MSB word; the read is clamped into it.
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
          const int* pp = probs + min(plane, kMaxPlanes - 1) * S;
          const uint32_t pmask = plane_mask(plane);
          const bool sig = work >> 31;
          const int sym = code(sig, pp[kRefRow]);
          if (sig) work = refined(work, sym, plane, pmask);
          const bool insig = (work >> 31) == 0;
          const int bit = code(insig, pp[kSigRow + ctx]);
          const bool newly = insig && bit;
          const uint32_t upd =
              sign(newly, nb, plane, pp + kSignRow,
                   pmask | kSigBit | ((uint32_t)plane << 24));
          if (newly) work |= upd;
        }
        *cell(g, r, lane, phase) = work;
        __syncwarp();
      }
    }
  }
};

// A column's 64 rows, a bit each, in two words kept rotated: while row r
// is decoded, bit j of `lo` is row (j + r - 1) mod 64, so row r - 1 is bit
// 0, row r bit 1 and row r + 1 bit 2, and a context reads fixed bits.
struct RowBits {
  uint32_t lo = 0;
  uint32_t hi = 0;

  // on to the next row: the 64 bits rotated right by one
  __device__ __forceinline__ void next() {
    const uint32_t l = __funnelshift_r(lo, hi, 1);
    hi = __funnelshift_r(hi, lo, 1);
    lo = l;
  }

  // bit r = row r; valid between planes, when the rotation is back at row 0
  __device__ __forceinline__ uint64_t rows() const {
    const uint64_t w = ((uint64_t)hi << 32) | lo;
    return (w >> 1) | (w << 63);
  }
};

__device__ __forceinline__ uint64_t warp_or(uint64_t v) {
  return ((uint64_t)__reduce_or_sync(kFullMask, (uint32_t)(v >> 32)) << 32) |
         __reduce_or_sync(kFullMask, (uint32_t)v);
}

// The stream words that the cp2 decoder may read next, in a ring of 64
// shared words: slots [filled - 64, filled), with filled > counter + 32,
// since a coder step reserves at most 32 slots past the counter. The next
// 32 words are in flight in registers, a word a lane, loaded a refill
// ahead, so that no coder step waits on device memory.
struct StreamWindow {
  static constexpr int kWords = 2 * kLanes;
  int32_t* ring;
  const int32_t* cs;
  int lane;
  int filled;
  int32_t next;

  __device__ __forceinline__ uint32_t operator[](int slot) const {
    return (uint32_t)ring[slot & (kWords - 1)];
  }

  __device__ __forceinline__ void start() {
    ring[lane] = cs[lane];
    ring[kLanes + lane] = cs[kLanes + lane];
    filled = kWords;
    next = cs[kWords + lane];
    __syncwarp();
  }

  // before each coder step: one refill restores filled > counter + 32
  __device__ __forceinline__ void keep_ahead(int counter) {
    if (counter + kLanes >= filled) {
      ring[(filled + lane) & (kWords - 1)] = next;
      filled += kLanes;
      next = cs[min(filled + lane, kBlockWords - 1)];
      __syncwarp();
    }
  }
};

// The cp2 decoder (mode kModeCp2) on lane-owned column bitmasks; see the
// note at the head of this file. Besides its own two columns each lane
// holds the column of each neighbour lane that its contexts read (lane
// l-1's odd one, lane l+1's even one), kept by the ballots of the SPP
// steps. A cell's word in `words` ([row][phase][lane]) is touched only by
// its own lane. Planes at and above 28 come only from a corrupt MSB word
// (a valid word's magnitude has 23 bits); there the grid decoder's plane
// mask reaches its state flags and this decoder's cannot, so the two may
// differ on such a stream.
struct MaskDecoder {
  DecoderLane s;
  int counter;
  int prec;
  int lane;
  StreamWindow win;
  uint32_t* words;
  uint32_t left;     // lane l-1's bit of a ballot (none in lane 0)
  uint32_t right;    // lane l+1's bit (none in lane 31)
  RowBits sig[2];    // significant, by phase (column 2 lane + phase)
  RowBits neg[2];    // negative
  RowBits side_sig[2];   // the neighbour column of phase 0 (lane l-1's
  RowBits side_neg[2];   // odd) and of phase 1 (lane l+1's even)

  __device__ __forceinline__ int code(bool active, int prob) {
    win.keep_ahead(counter);
    return ac_decode(s, counter, active, prob, prec, lane, win);
  }

  __device__ __forceinline__ uint32_t* word(int r, int phase) {
    return &words[(2 * r + phase) * kLanes + lane];
  }

  // The context word of a cell from the three windows that hold its
  // neighbours (rows r-1..r+1 in bits 0-2): the neighbour lane's column,
  // the lane's other column, and the cell's own column.
  __device__ __forceinline__ static uint32_t context(uint32_t side,
                                                     uint32_t other,
                                                     uint32_t own) {
    return (side & 7u) | ((other & 7u) << 3) | ((own & 5u) << 6);
  }

  // The SPP step of cell (r, P); `edge` clears the rows outside the block.
  // The cell is the neighbour column of phase 1 - P of the lane beside it.
  template <int P>
  __device__ __forceinline__ void spp_step(int r, uint32_t edge,
                                           const int* pp,
                                           const SignProbs& sign_probs,
                                           uint32_t set) {
    RowBits& own = sig[P];
    const uint32_t nb = context(side_sig[P].lo, sig[1 - P].lo, own.lo) &
                        edge;
    const bool insig = (own.lo & 2u) == 0;
    const int bit = code(insig, pp[kSigRow + __popc(nb)]);
    const bool newly = insig && bit;
    const uint32_t turned = __ballot_sync(kFullMask, newly);
    if (turned != 0) {
      const uint32_t negative_nb =
          ((side_neg[P].lo & 2u) | ((neg[1 - P].lo & 2u) << 3) |
           ((neg[P].lo & 5u) << 6)) & nb;
      const int sctx = sign_context(nb & ~negative_nb, negative_nb);
      const int ssym = code(newly, sign_probs.at(sctx >> 1));
      const uint32_t negative = (ssym & 1) == (sctx & 1) ? 0u : 1u;
      const uint32_t turned_negative =
          __ballot_sync(kFullMask, newly && negative);
      if (newly) {
        own.lo |= 2u;
        neg[P].lo |= negative << 1;
        *word(r, P) = set | negative;
      }
      const uint32_t from = P == 0 ? right : left;
      side_sig[1 - P].lo |= (turned & from) ? 2u : 0u;
      side_neg[1 - P].lo |= (turned_negative & from) ? 2u : 0u;
    }
  }

  __device__ __forceinline__ void spp(const int* pp, int plane) {
    const uint32_t set = plane_mask(plane);
    const SignProbs sign_probs{pp[kSignRow], pp[kSignRow + 1],
                               pp[kSignRow + 2], pp[kSignRow + 3]};
    for (int r = 0; r < kRows; ++r) {
      const uint32_t edge = (r == 0 ? ~kTopRows : ~0u) &
                            (r == kRows - 1 ? ~kBottomRows : ~0u);
      spp_step<0>(r, edge, pp, sign_probs, set);
      spp_step<1>(r, edge, pp, sign_probs, set);
#pragma unroll
      for (int p = 0; p < 2; ++p) {
        sig[p].next();
        neg[p].next();
        side_sig[p].next();
        side_neg[p].next();
      }
    }
  }

  // MRP over the 32 rows from `base`: the steps whose phase has a refining
  // cell (`any`, bit i = row base + i); the cells to refine (`ref`) are
  // those significant before this plane's SPP. Each lane loads and stores
  // its cell unconditionally, so the step has no branch.
  __device__ __forceinline__ void mrp_rows(int base, const uint32_t any[2],
                                           const uint32_t ref[2], int prob,
                                           int plane, uint32_t pmask) {
    for (uint32_t rows = any[0] | any[1]; rows != 0; rows &= rows - 1) {
      const int i = __ffs(rows) - 1;
#pragma unroll
      for (int phase = 0; phase < 2; ++phase) {
        if ((any[phase] >> i) & 1u) {
          const bool refine = (ref[phase] >> i) & 1u;
          uint32_t* c = word(base + i, phase);
          const uint32_t cur = *c;
          const int sym = code(refine, prob);
          *c = refine ? refined(cur, sym, plane, pmask) : cur;
        }
      }
    }
  }

  // Planes `top` down to 0; returns the MRP steps skipped.
  __device__ __forceinline__ int planes(const int* probs, int top) {
    int skipped = 0;
    for (int plane = top; plane >= 0; --plane) {
      const int* pp = probs + plane * prob_stride<2>();
      const uint64_t ref[2] = {sig[0].rows(), sig[1].rows()};
      const uint64_t any[2] = {warp_or(ref[0]), warp_or(ref[1])};
      spp(pp, plane);
      const uint32_t pmask = plane_mask(plane);
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int shift = 32 * half;
        const uint32_t any_h[2] = {(uint32_t)(any[0] >> shift),
                                   (uint32_t)(any[1] >> shift)};
        const uint32_t ref_h[2] = {(uint32_t)(ref[0] >> shift),
                                   (uint32_t)(ref[1] >> shift)};
        mrp_rows(shift, any_h, ref_h, pp[kRefRow], plane, pmask);
      }
      skipped += 2 * kRows - __popcll(any[0]) - __popcll(any[1]);
    }
    return skipped;
  }
};

template <int CP, bool BULK>
__global__ void __launch_bounds__(kLanes)
bpc_decode_kernel(const int32_t* __restrict__ streams,
                  const int32_t* __restrict__ sizes,
                  const int32_t* __restrict__ lut, int lut_len,
                  BlockMeta meta, int n_planes, int prec, int stride,
                  int32_t* __restrict__ coeffs,
                  unsigned long long* __restrict__ counts) {
  constexpr int S = prob_stride<CP>();
  __shared__ int probs[kMaxPlanes * S];
  const int blk = blockIdx.x;
  const int lane = threadIdx.x;
  const int32_t* cs = streams + (size_t)blk * kBlockWords;
  int2* dst = reinterpret_cast<int2*>(coeffs + (size_t)blk * kBlockWords);

  if (sizes[blk] == kBlockWords) {
    // raw copy: word[row][2 lane + parity] = cs[lane*128 + row*2 + parity]
    const int2* raw = reinterpret_cast<const int2*>(cs + lane * 2 * kRows);
    for (int r = 0; r < kRows; ++r) {
      const int2 v = raw[r];
      dst[r * kLanes + lane] = make_int2(to_coeff((uint32_t)v.x & 0xFFFFu),
                                         to_coeff((uint32_t)v.y & 0xFFFFu));
    }
    return;
  }
  const int msb_word = cs[0];
  const int msb = msb_word == 32 ? -1 : msb_word;

  if constexpr (CP == 2 && !BULK) {
    __shared__ uint4 words[kRows * 2 * kLanes / 4];
    for (int i = lane; i < kRows * 2 * kLanes / 4; i += kLanes) {
      words[i] = make_uint4(0u, 0u, 0u, 0u);
    }
    __syncwarp();
    stage_block<CP, BULK>(probs, lut, lut_len, meta, blk, msb, stride, lane);
    __shared__ int32_t ring[StreamWindow::kWords];
    MaskDecoder dec{DecoderLane{}, 0, prec, lane, {ring, cs, lane},
                    reinterpret_cast<uint32_t*>(words),
                    (1u << lane) >> 1, (1u << lane) << 1};
    const int top = min(msb, n_planes - 1);
    dec.win.start();
    const int skipped = dec.planes(probs, top);
    if (counts != nullptr && lane == 0 && top >= 0) {
      atomicAdd(&counts[0], (unsigned long long)(4 * kRows * (top + 1)));
      atomicAdd(&counts[1], (unsigned long long)skipped);
    }
    for (int r = 0; r < kRows; ++r) {
      dst[r * kLanes + lane] = make_int2(to_coeff(*dec.word(r, 0)),
                                         to_coeff(*dec.word(r, 1)));
    }
  } else {
    __shared__ Grid g;
    // zero border; with cp=3 every interior cell starts as a candidate
    // (initializeCoefficients3CP, bpc_jax.py:809-812)
    uint32_t* flat_e = &g.e[0][0];
    uint32_t* flat_o = &g.o[0][0];
    for (int i = lane; i < kGridRows * kGridCols; i += kLanes) {
      const int r = i / kGridCols;
      const int c = i - r * kGridCols;
      const bool inner = CP == 3 && r >= 1 && r <= kRows;
      flat_e[i] = inner && c < kLanes ? kCpBit : 0u;
      flat_o[i] = inner && c >= 1 ? kCpBit : 0u;
    }
    __syncwarp();
    const int consec = stage_block<CP, BULK>(probs, lut, lut_len, meta, blk,
                                             msb, stride, lane);

    Decoder dec{g, DecoderLane{}, 0, prec, lane, cs};
    for (int plane = min(msb, n_planes - 1); plane >= (BULK ? consec : 0);
         --plane) {
      const int* pp = probs + plane * S;
      if (CP == 2 || plane < msb) {
        dec.spp<CP>(pp, plane);
        dec.mrp(pp, plane);
      }
      if (CP == 3) dec.cp(pp, plane);
    }
    if (BULK) {
      const int entry = bulk_entry(msb, consec);
      if (entry >= 0) dec.bulk<S>(probs, entry, n_planes);
    }

    __syncwarp();
    for (int r = 0; r < kRows; ++r) {
      dst[r * kLanes + lane] = make_int2(to_coeff(g.e[r + 1][lane]),
                                         to_coeff(g.o[r + 1][lane + 1]));
    }
  }
}

template <int CP, bool BULK>
void launch(const int32_t* streams, const int32_t* sizes, const int32_t* lut,
            int lut_len, const BlockMeta& meta, int n, int n_planes, int prec,
            int stride, int32_t* coeffs, unsigned long long* counts,
            cudaStream_t stream) {
  bpc_decode_kernel<CP, BULK><<<n, kLanes, 0, stream>>>(
      streams, sizes, lut, lut_len, meta, n_planes, prec, stride, coeffs,
      counts);
}

}  // namespace
}  // namespace picsong

// C entry point: launches the variant of `mode` (picsong::Mode) on
// `stream`, does not synchronise, and returns cudaGetLastError() so that a
// refused launch is reported to the caller. The cp2 variant adds its steps
// in scope and its skipped steps to counts[0] and counts[1] (int64 on the
// device; null counts nothing).
extern "C" int picsong_bpc_decode(const int32_t* streams,
                                  const int32_t* sizes, const int32_t* lut,
                                  int lut_len, const int32_t* ref_base,
                                  const int32_t* sig_base,
                                  const int32_t* sign_base,
                                  const int32_t* cp_sig_base,
                                  const int32_t* cp_sign_base,
                                  const float* k_over_l2, int n, int n_planes,
                                  int prec, int stride, int mode,
                                  int32_t* coeffs, long long* counts,
                                  void* stream) {
  using namespace picsong;
  const BlockMeta meta{ref_base, sig_base, sign_base,
                       cp_sig_base, cp_sign_base, k_over_l2};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  unsigned long long* c = reinterpret_cast<unsigned long long*>(counts);
  if (n > 0) {
    switch (mode) {
      case kModeCp2:
        launch<2, false>(streams, sizes, lut, lut_len, meta, n, n_planes,
                         prec, stride, coeffs, c, s);
        break;
      case kModeCp3:
        launch<3, false>(streams, sizes, lut, lut_len, meta, n, n_planes,
                         prec, stride, coeffs, c, s);
        break;
      case kModeBulk:
        launch<2, true>(streams, sizes, lut, lut_len, meta, n, n_planes,
                        prec, stride, coeffs, c, s);
        break;
      default:
        return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  return static_cast<int>(cudaGetLastError());
}
