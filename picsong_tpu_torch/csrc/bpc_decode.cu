// BPC-PaCo decoder for Hopper (sm_90a), in three modes.
//
// Replaces the Pallas kernel `_make_kernel`, launched by `_decode_chunks`
// (picsong_tpu/entropy/bpc_pallas.py:707), together with its XLA
// preparation and finish (`_prepare_and_decode`, :760-794): mode cp2.
// Modes cp3 and bulk replace the XLA programs the JAX package runs for
// cp=3 and k > 0 (picsong_tpu/entropy/bpc_jax.py: `_spp_row_body` with
// three_cp :307-357, `_cp_row_body` :450-488, `_bulk_pass` :537-639,
// scheduled by `decode_blocks` :769-853). One warp per codeblock, one CTA
// of 32 threads per warp. Each CTA rebuilds its block's sign-magnitude
// words in the shared column grids by replaying the encoder's scan (see
// bpc_encode.cu for the passes of each mode), reading each codeword
// straight from streams[blk][slot] when a lane's interval empties, and
// writes the (64, 64) int32 coefficients. With cp=3 every cell starts as a
// cleanup-pass candidate (bit 30). Raw blocks (sizes == 4096) are copied
// out of their lane-major layout and empty blocks (word 0 == 32) decode to
// zeros, as in the Pallas wrapper.
//
// What bounds it on this card: the same serial per-warp scan as the
// encoder, one dependent chain of coding steps per codeblock with ~8 warps
// per SM at 1024 codeblocks, so latency, not bandwidth. Codeword reads are
// data-dependent but sequential per block (slot = counter + rank), so they
// hit the same few cache lines of a 16 KB stream in turn. The Pallas
// kernel's tape slabs, fetch window, one-hot contraction and DMA
// semaphores worked around Mosaic's missing gather and have no
// counterpart: a lane simply loads stream[slot].
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

// One arithmetic-decoder step for the whole warp (bpc_jax._ac_decode). The
// codeword compare is unsigned: unwritten slots hold -1 = 0xFFFFFFFF.
__device__ __forceinline__ int ac_decode(DecoderLane& s, int& counter,
                                         bool active, int prob, int prec,
                                         int lane, const int32_t* cs) {
  const bool need = active && s.size == 0;
  const int slot = reserve(need, counter, lane);
  if (need) {
    s.cw = (uint32_t)cs[slot];
    s.low = 0;
    s.size = kIntervalInit;
  }
  int sym = 0;
  if (active) {
    const int aux = ((s.size * prob) >> prec) + 1;
    const int aux2 = s.low + aux;
    if (s.cw >= (uint32_t)aux2) {
      s.size -= aux;
      s.low = aux2;
      sym = 1;
    } else {
      s.size = aux - 1;
    }
  }
  return sym;
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
        const uint32_t upd = sign(newly, nb, 0, pp + kSignRow, set);
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
        const uint32_t upd = sign(newly, nb, 0, pp + kCpSignRow, set);
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

template <int CP, bool BULK>
__global__ void __launch_bounds__(kLanes)
bpc_decode_kernel(const int32_t* __restrict__ streams,
                  const int32_t* __restrict__ sizes,
                  const int32_t* __restrict__ lut, int lut_len,
                  BlockMeta meta, int n_planes, int prec, int stride,
                  int32_t* __restrict__ coeffs) {
  constexpr int S = prob_stride<CP>();
  __shared__ Grid g;
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

template <int CP, bool BULK>
void launch(const int32_t* streams, const int32_t* sizes, const int32_t* lut,
            int lut_len, const BlockMeta& meta, int n, int n_planes, int prec,
            int stride, int32_t* coeffs, cudaStream_t stream) {
  bpc_decode_kernel<CP, BULK><<<n, kLanes, 0, stream>>>(
      streams, sizes, lut, lut_len, meta, n_planes, prec, stride, coeffs);
}

}  // namespace
}  // namespace picsong

// C entry point: launches the variant of `mode` (picsong::Mode) on
// `stream`, does not synchronise, and returns cudaGetLastError() so that a
// refused launch is reported to the caller.
extern "C" int picsong_bpc_decode(const int32_t* streams,
                                  const int32_t* sizes, const int32_t* lut,
                                  int lut_len, const int32_t* ref_base,
                                  const int32_t* sig_base,
                                  const int32_t* sign_base,
                                  const int32_t* cp_sig_base,
                                  const int32_t* cp_sign_base,
                                  const float* k_over_l2, int n, int n_planes,
                                  int prec, int stride, int mode,
                                  int32_t* coeffs, void* stream) {
  using namespace picsong;
  const BlockMeta meta{ref_base, sig_base, sign_base,
                       cp_sig_base, cp_sign_base, k_over_l2};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n > 0) {
    switch (mode) {
      case kModeCp2:
        launch<2, false>(streams, sizes, lut, lut_len, meta, n, n_planes,
                         prec, stride, coeffs, s);
        break;
      case kModeCp3:
        launch<3, false>(streams, sizes, lut, lut_len, meta, n, n_planes,
                         prec, stride, coeffs, s);
        break;
      case kModeBulk:
        launch<2, true>(streams, sizes, lut, lut_len, meta, n, n_planes,
                        prec, stride, coeffs, s);
        break;
      default:
        return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  return static_cast<int>(cudaGetLastError());
}
