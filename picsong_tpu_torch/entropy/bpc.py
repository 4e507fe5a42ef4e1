"""Plain PyTorch BPC-PaCo and the host-side coder metadata.

This is the readable version of the two CUDA kernels in `csrc/`: the same
computation written as torch ops over `(32, N)` tensors, 32 warp lanes by N
codeblocks, one loop step per (bitplane, pass, row, phase). It runs
wherever torch runs; the CPU uses it as the coder, the tests hold it
against the JAX package and the NumPy oracle, and on a card the kernels are
held byte-equal to it. Nothing on the CUDA main path calls it.

`encode_blocks_plain` / `decode_blocks_plain` take the arguments of
`picsong_tpu.entropy.bpc_jax.encode_blocks` / `decode_blocks` and mirror
them, construct for construct, in every mode: two coding passes (SPP, MRP),
three (SPP, MRP, cleanup pass CP), and two with complexity scalability
(k > 0: the planes below the split run as one fused multi-bitplane bulk
pass). What they mirror:
- the arithmetic coder `_ac_encode` / `_ac_decode` (bpc_jax.py:212-259),
  slots reserved in ascending lane order at `min(rank + counter, 4094) + 1`;
- the contexts `_sig_ctx`, `_sig_ctx_bulk`, `_sign_ctx`, `_sign_ctx_bulk`
  (:153-189);
- the row bodies `_spp_row_body` (:307-357, with `three_cp`),
  `_mrp_row_body` (:372-406), `_cp_row_body` (:450-488) and `_bulk_pass`
  (:537-639);
- the schedule, split plane and finish of `encode_blocks` (:665-766) and
  `decode_blocks` (:769-853): word 0 holds the MSB (32 for an empty block),
  unwritten slots hold -1, `sizes` is counter + 1, and a block whose size
  reaches 4096 becomes a raw lane-major copy.

Coefficient words are (|v| << 1) | sign plus state flags in bits 24-31
(spec.py:39-43): the plane of significance in bits 24-28, refinement in
bit 29, the cleanup-pass candidate (cp=3) in bit 30, significance in bit
31. They are kept as int64 so that bit 31 reads as a plain positive bit:
torch has no usable uint32 arithmetic on the CPU.

The host helpers (`block_metadata`, `planes_for_*`, `check_planes_bound`,
`PlaneOverflowError`) are NumPy copies of bpc_jax's, which cannot be
imported without JAX.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core import spec
from ..core.lut import LUTParams, group_base

_LANES = spec.LANES
_ROWS = spec.CBLOCK_LENGTH
_SIG_BIT = 1 << spec.BIT_SIGNIFICANT
_CP_BIT = 1 << spec.BIT_CP_CANDIDATE
_REF_BIT = 1 << spec.BIT_REFINEMENT
_I64 = torch.int64


# --------------------------------------------------------------------------
# Host-side per-codeblock metadata (NumPy; copies of bpc_jax's)
# --------------------------------------------------------------------------

def block_metadata(levels: np.ndarray, subbands: np.ndarray,
                   params: LUTParams, wavelet_levels: int, coding_passes: int,
                   k_factor: float):
    """Per-codeblock LUT group bases and CS coefficients (NumPy, host)."""
    off = params.section_offsets(wavelet_levels, coding_passes)
    n = len(levels)
    meta = {}
    for name, nctx in (("ref", params.ctx_refinement),
                       ("sig", params.ctx_significance),
                       ("sign", params.ctx_sign)):
        base = np.array([off[name] + group_base(params, wavelet_levels,
                                                int(levels[i]), int(subbands[i]), nctx)
                         for i in range(n)], dtype=np.int32)
        meta[name] = base
    if coding_passes == 3:
        aux = (params.section_size(params.ctx_significance, wavelet_levels)
               + params.section_size(params.ctx_sign, wavelet_levels))
        meta["cp_sig"] = meta["sig"] + aux
        meta["cp_sign"] = meta["sign"] + aux
    # k / L2Norm per codeblock (BPCEngine.cu:1684-1692)
    k_over_l2 = np.zeros(n, dtype=np.float32)
    if k_factor > 0:
        for i in range(n):
            row, col = spec.l2norm_column(int(levels[i]), int(subbands[i]),
                                          wavelet_levels)
            k_over_l2[i] = np.float32(k_factor) / spec.WAVELET_QSTEPS[row][col]
    meta["k_over_l2"] = k_over_l2
    meta["stride"] = params.stride_per_group(wavelet_levels)
    return meta


def _meta_args(levels, subbands, params, wavelet_levels, coding_passes,
               k_factor):
    """(ref, sig, sign, cp_sig, cp_sign, k_over_l2) per-codeblock arrays."""
    meta = block_metadata(np.asarray(levels), np.asarray(subbands), params,
                          wavelet_levels, coding_passes, k_factor)
    zeros = np.zeros(len(levels), dtype=np.int32)
    return (meta["ref"], meta["sig"], meta["sign"],
            meta.get("cp_sig", zeros), meta.get("cp_sign", zeros),
            meta["k_over_l2"])


def planes_for_magnitude(max_magnitude: int, quantum: int = 4) -> int:
    """Bitplane count covering a maximum |coefficient|, rounded up to a
    multiple of `quantum` (the JAX package's rule, kept so that both
    packages pick the same n_planes)."""
    msb = int(max_magnitude).bit_length() - 1 if max_magnitude > 0 else -1
    need = msb + 1
    return max(-(-need // quantum) * quantum, quantum) if need > 0 else quantum


class PlaneOverflowError(OverflowError):
    """The bitplane bound was lower than a codeblock's true MSB.

    Raised by check_planes_bound when an encode ran with n_planes <= MSB:
    the planes above the bound were never coded, so the stream would decode
    to corrupt data. `needed` is a valid n_planes to retry with."""

    def __init__(self, msb: int, n_planes: int, quantum: int = 4):
        self.msb = msb
        self.needed = max(-(-(msb + 1) // quantum) * quantum, quantum)
        super().__init__(
            f"codeblock MSB {msb} exceeds the static bitplane bound "
            f"n_planes={n_planes}; high bitplanes were not coded. "
            f"Retry with n_planes >= {self.needed}.")


def check_planes_bound(msb_words, sizes, n_planes: int) -> None:
    """Fail loudly if any encoded block's true MSB exceeded the bound.

    Word 0 of every stream is the block's true MSB, so this runs on the
    downloaded streams at no extra cost. Raw fallback blocks
    (sizes == 4096) carry verbatim data and are exempt."""
    msb_words = np.asarray(msb_words)
    sizes = np.asarray(sizes)
    real = (msb_words != 32) & (sizes != spec.CBLOCK_SIZE)
    if real.any():
        msb = int(msb_words[real].max())
        if msb + 1 > n_planes:
            raise PlaneOverflowError(msb, n_planes)


def planes_for_streams(msb_words, sizes, quantum: int = 4) -> int:
    """Bitplane count for decoding a batch of codeblock streams."""
    msb_words = np.asarray(msb_words)
    sizes = np.asarray(sizes)
    real = (msb_words != 32) & (sizes != spec.CBLOCK_SIZE)
    msb = int(msb_words[real].max()) if real.any() else -1
    need = msb + 1
    return max(-(-need // quantum) * quantum, quantum) if need > 0 else quantum


def split_plane(msb: torch.Tensor, k_over_l2: torch.Tensor) -> torch.Tensor:
    """The complexity-scalability split plane per block,
    max(floor(float32(msb) * k_over_l2), 0), in float32 as bpc_jax
    computes it (bpc_jax.py:698). The oracle computes it in float64; the
    two differ only where both exceed msb + 1, past which only
    min(consec, msb + 1) reaches the coder."""
    prod = msb.to(torch.float32) * k_over_l2.to(torch.float32)
    return torch.clamp(torch.floor(prod), min=0).to(_I64)


# --------------------------------------------------------------------------
# Layouts: (N, 64, 64) words <-> even/odd column grids (66, 33, N)
# --------------------------------------------------------------------------

def _to_grids(words: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Even and odd columns, each with a one-cell zero border: te[1 + r, l]
    is word[r, 2l], to[1 + r, l + 1] is word[r, 2l + 1]."""
    n = words.shape[0]
    te = torch.zeros((_ROWS + 2, _LANES + 1, n), dtype=_I64,
                     device=words.device)
    to = torch.zeros_like(te)
    pairs = words.to(_I64).reshape(n, _ROWS, _LANES, 2).permute(1, 2, 3, 0)
    te[1:-1, :_LANES, :] = pairs[:, :, 0, :]
    to[1:-1, 1:, :] = pairs[:, :, 1, :]
    return te, to


def _from_grids(te: torch.Tensor, to: torch.Tensor) -> torch.Tensor:
    n = te.shape[-1]
    pairs = torch.stack([te[1:-1, :_LANES, :], to[1:-1, 1:, :]], dim=2)
    return pairs.permute(3, 0, 1, 2).reshape(n, _ROWS, _ROWS)


def _raw_layout(words: torch.Tensor) -> torch.Tensor:
    """(N, 64, 64) words -> (N, 4096) int32 lane-major low-16 copy:
    out[lane*128 + row*2 + parity] = T[row, lane*2 + parity]."""
    n = words.shape[0]
    v = (words & 0xFFFF).to(torch.int32)
    return v.reshape(n, _ROWS, _LANES, 2).permute(0, 2, 1, 3).reshape(n, -1)


def _raw_unlayout(cs: torch.Tensor) -> torch.Tensor:
    n = cs.shape[0]
    v = cs.to(_I64) & 0xFFFF
    return v.reshape(n, _LANES, _ROWS, 2).permute(0, 2, 1, 3).reshape(
        n, _ROWS, _ROWS)


def _probs_at(lut, ref_b, sig_b, sign_b, planes: torch.Tensor) -> torch.Tensor:
    """(P, 16, N) probabilities at `planes`, (P, N) or (P, 1): rows 0-8
    significance ctx, 9-12 sign ctx, 13 refinement, 14-15 padding; every
    index clipped into the table."""
    n = ref_b.shape[0]
    lut = lut.to(_I64)
    top = lut.shape[0] - 1
    p = planes.to(_I64)[:, None, :]
    i9 = torch.arange(9, dtype=_I64, device=lut.device)[None, :, None]
    i4 = torch.arange(4, dtype=_I64, device=lut.device)[None, :, None]
    sig = lut[torch.clamp(sig_b.to(_I64)[None, None, :] + p * 9 + i9, 0, top)]
    sign = lut[torch.clamp(sign_b.to(_I64)[None, None, :] + p * 4 + i4, 0, top)]
    ref = lut[torch.clamp(ref_b.to(_I64)[None, None, :] + p, 0, top)]
    pad = torch.full((planes.shape[0], 2, n), 64, dtype=_I64, device=lut.device)
    return torch.cat([sig, sign, ref, pad], dim=1)


def _prob_tables(lut, ref_b, sig_b, sign_b, n_planes: int) -> torch.Tensor:
    """(n_planes, 16, N) probabilities of every plane (_probs_at)."""
    planes = torch.arange(n_planes, dtype=_I64, device=lut.device)[:, None]
    return _probs_at(lut, ref_b, sig_b, sign_b, planes)


# --------------------------------------------------------------------------
# Contexts
# --------------------------------------------------------------------------

def _neighbors(te3, to3, phase: int):
    """Current cells and 8-neighborhood, (32, N) each, for one phase."""
    if phase == 0:
        cur = te3[1, :_LANES, :]
        nb = dict(ul=to3[0, :_LANES, :], up=te3[0, :_LANES, :],
                  ur=to3[0, 1:, :], lf=to3[1, :_LANES, :], rt=to3[1, 1:, :],
                  bl=to3[2, :_LANES, :], bt=te3[2, :_LANES, :],
                  br=to3[2, 1:, :])
    else:
        cur = to3[1, 1:, :]
        nb = dict(ul=te3[0, :_LANES, :], up=to3[0, 1:, :], ur=te3[0, 1:, :],
                  lf=te3[1, :_LANES, :], rt=te3[1, 1:, :],
                  bl=te3[2, :_LANES, :], bt=to3[2, 1:, :], br=te3[2, 1:, :])
    return cur, nb


def _sig_ctx(nb) -> torch.Tensor:
    return sum((v >> 31) for v in nb.values())


def _sig_ctx_bulk(nb, plane: torch.Tensor) -> torch.Tensor:
    """Neighbours significant at or above `plane` (N,)."""
    return sum((((v >> 24) & 31) >= plane).to(_I64) for v in nb.values())


def _sign_ctx_table(h, v) -> torch.Tensor:
    out = torch.zeros_like(h)
    out = torch.where((h == 0) & (v > 0), 2, out)
    out = torch.where((h == 0) & (v < 0), 3, out)
    out = torch.where((h > 0) & (v == 0), 4, out)
    out = torch.where((h > 0) & (v > 0), 6, out)
    out = torch.where((h < 0) & (v == 0), 5, out)
    out = torch.where((h < 0) & (v > 0), 1, out)
    out = torch.where((h < 0) & (v < 0), 7, out)
    return out


def _sign_ctx(nb, plane: torch.Tensor | None = None) -> torch.Tensor:
    """Sign context code with the expected sign in bit 0; with `plane`
    (N,), only neighbours significant at or above it count (the bulk
    pass's _sign_ctx_bulk)."""

    def c(v):
        sig = (v >> 31) != 0
        if plane is not None:
            sig = sig & (((v >> 24) & 31) >= plane)
        return torch.where(sig, torch.where((v & 1) == 1, -1, 1), 0)

    return _sign_ctx_table(c(nb["lf"]) + c(nb["rt"]), c(nb["up"]) + c(nb["bt"]))


def _write_cells(te, to, r: int, phase: int, vals) -> None:
    if phase == 0:
        te[r + 1, :_LANES, :] = vals
    else:
        to[r + 1, 1:, :] = vals


def _plane_mask(plane: int) -> int:
    """Decoder approximation mask at a plane: 0x3 << p, or 0x2 at p == 0."""
    return (3 << plane) if plane >= 1 else 2


# --------------------------------------------------------------------------
# The 32-lane arithmetic coder over (32, N) state
# --------------------------------------------------------------------------

class _Coder:
    """Per-lane interval state plus the per-block slot counter; an encoder
    (writing `out`) or, given `streams`, a decoder.

    `word` is the reserved slot on encode and the current codeword on
    decode (the same register in the reference, BPCEngine.cu:404-442)."""

    def __init__(self, n: int, device, prec: int, streams=None):
        z = torch.zeros((_LANES, n), dtype=_I64, device=device)
        self.low, self.size, self.word = z, z.clone(), z.clone()
        self.counter = torch.zeros(n, dtype=_I64, device=device)
        self.prec = prec
        self.encoding = streams is None
        if self.encoding:
            # column 4096 is a sink for the lanes that store nothing
            self.out = torch.full((n, spec.CBLOCK_SIZE + 1), -1, dtype=_I64,
                                  device=device)
        else:
            # codewords as unsigned 32-bit values: -1 reads 0xFFFFFFFF
            self.streams_u = streams.to(_I64) & 0xFFFFFFFF

    def _reserve(self, need):
        """Slots for the lanes in `need`, ascending by lane."""
        needi = need.to(_I64)
        rank = torch.cumsum(needi, dim=0) - needi
        nslot = torch.clamp(rank + self.counter, max=spec.MAX_RESERVED_SLOT) + 1
        self.counter = torch.clamp(self.counter + needi.sum(dim=0),
                                   max=spec.MAX_SLOT_COUNT)
        self.low = torch.where(need, 0, self.low)
        self.size = torch.where(need, spec.AC_INTERVAL_INIT, self.size)
        return nslot

    def code(self, active, bits, probs) -> torch.Tensor:
        """One coding step of the `active` lanes: encodes `bits` and returns
        them, or decodes and returns the symbols (`bits` unused)."""
        need = active & (self.size == 0)
        nslot = self._reserve(need)
        if self.encoding:
            self.word = torch.where(need, nslot, self.word)
            aux = ((self.size * probs) >> self.prec) + bits
            one = active & (bits == 1)
            zero = active & (bits == 0)
            self.size = torch.where(zero, aux,
                                    torch.where(one, self.size - aux, self.size))
            self.low = torch.where(one, self.low + aux, self.low)
            # a lane whose interval empties flushes `low` to its slot
            flush = active & (self.size == 0)
            slot = torch.where(flush, self.word, spec.CBLOCK_SIZE)
            self.out.scatter_(1, slot.T, self.low.T)
            return bits
        fetched = torch.gather(self.streams_u, 1, nslot.T).T
        self.word = torch.where(need, fetched, self.word)
        aux = ((self.size * probs) >> self.prec) + 1
        aux2 = self.low + aux
        one = active & (self.word >= aux2)
        zero = active & ~one
        self.size = torch.where(one, self.size - aux,
                                torch.where(zero, aux - 1, self.size))
        self.low = torch.where(one, aux2, self.low)
        return one.to(_I64)

    def sign_step(self, newly, x, sctx, sprobs, flag, pmask):
        """Code the sign of the `newly` significant lanes of `x` and set
        their flags; a decoder also sets the sign and the plane's
        approximation bits `pmask`."""
        ssym = self.code(newly, torch.where((x & 1) == (sctx & 1), 0, 1),
                         sprobs)
        if self.encoding:
            return torch.where(newly, x | flag, x)
        sbit = torch.where((ssym & 1) == (sctx & 1), 0, 1)
        return torch.where(newly, x | pmask | flag | sbit, x)

    def refine(self, active, x, shift, pmask, probs):
        """Code one refinement bit of the `active` lanes of `x`; a decoder
        sets it and its midpoint below."""
        sym = self.code(active, (x >> shift) & 1, probs)
        if self.encoding:
            return x
        patt = ((sym << 1) + 1) << (shift - 1)
        return torch.where(active, (x & ~pmask) | (pmask & patt), x)


# --------------------------------------------------------------------------
# Coding passes: a 64-row x 2-phase scan each
# --------------------------------------------------------------------------

def _spp_pass(te, to, ac: _Coder, plane: int, act, ptab,
              three_cp: bool) -> None:
    """Significance propagation (_spp_row_body). With `three_cp` only cells
    with a significant neighbour are coded, and an insignificant cell with
    none becomes a cleanup-pass candidate (bit 30)."""
    shift = plane + 1
    flag = _SIG_BIT | (plane << spec.BITPLANE_SHIFT)
    pmask = _plane_mask(plane)
    for r in range(_ROWS):
        te3, to3 = te[r:r + 3], to[r:r + 3]
        for phase in (0, 1):
            cur, nb = _neighbors(te3, to3, phase)
            insig = (cur >> 31) == 0
            ctx = _sig_ctx(nb)
            if three_cp:
                active = insig & (ctx > 0) & act
                candidate = insig & (ctx == 0) & act
            else:
                active = insig & act
            bits = ac.code(active, (cur >> shift) & 1,
                           torch.gather(ptab[0:9], 0, ctx))
            newly = active & (bits == 1)
            sctx = _sign_ctx(nb)
            upd = ac.sign_step(newly, cur, sctx,
                               torch.gather(ptab[9:13], 0, sctx >> 1), flag,
                               pmask)
            if three_cp:
                upd = torch.where(candidate, upd | _CP_BIT, upd)
            _write_cells(te, to, r, phase, upd)


def _mrp_pass(te, to, ac: _Coder, plane: int, act, ptab) -> None:
    """Magnitude refinement (_mrp_row_body): refines the cells significant
    before this plane and marks this plane's new ones for the next."""
    shift = plane + 1
    pmask = _plane_mask(plane)
    ref_prob = ptab[13:14].expand(_LANES, -1)
    for r in range(_ROWS):
        for phase in (0, 1):
            cur = te[r + 1, :_LANES] if phase == 0 else to[r + 1, 1:]
            refine = ((cur >> 29) & 1) == 1
            active = refine & act
            eligible = ~refine & ((cur >> 31) == 1) & act
            upd = ac.refine(active, cur, shift, pmask, ref_prob)
            _write_cells(te, to, r, phase,
                         torch.where(eligible, upd | _REF_BIT, upd))


def _cp_pass(te, to, ac: _Coder, plane: int, act, cptab) -> None:
    """Cleanup pass, cp=3 (_cp_row_body): codes the candidates with the cp
    probabilities and clears their bit 30; a cell significant here is
    refined from the next plane on (bit 29 in its flag)."""
    shift = plane + 1
    flag = _SIG_BIT | _REF_BIT | (plane << spec.BITPLANE_SHIFT)
    pmask = _plane_mask(plane)
    for r in range(_ROWS):
        te3, to3 = te[r:r + 3], to[r:r + 3]
        for phase in (0, 1):
            cur, nb = _neighbors(te3, to3, phase)
            active = (((cur >> 30) & 1) == 1) & act
            bits = ac.code(active, (cur >> shift) & 1,
                           torch.gather(cptab[0:9], 0, _sig_ctx(nb)))
            upd = torch.where(active, cur & ~_CP_BIT, cur)
            newly = active & (bits == 1)
            sctx = _sign_ctx(nb)
            upd = ac.sign_step(newly, upd, sctx,
                               torch.gather(cptab[9:13], 0, sctx >> 1), flag,
                               pmask)
            _write_cells(te, to, r, phase, upd)


def _bulk_pass(te, to, ac: _Coder, entry, act_blk, lut, ref_b, sig_b, sign_b,
               n_planes: int) -> None:
    """Fused multi-bitplane pass, k > 0 (_bulk_pass): cells scan row-major,
    and each codes planes entry..0 in an inner loop (refinement, then
    significance with the context frozen at the entry plane, then the sign
    at the inner plane). `entry` (N,) is clamped to >= 0; `act_blk` says
    which blocks run the pass."""
    n = entry.shape[0]
    plane_all = entry[None, :] - torch.arange(n_planes, dtype=_I64,
                                              device=entry.device)[:, None]
    act_all = act_blk[None, :] & (plane_all >= 0)          # (P, N)
    pu_all = torch.clamp(plane_all, min=0)
    tabs = _probs_at(lut, ref_b, sig_b, sign_b, pu_all)    # (P, 16, N)
    shift_all = pu_all + 1
    pmask_all = torch.where(pu_all >= 1, 3 << pu_all, 2)
    flag_all = _SIG_BIT | (pu_all << spec.BITPLANE_SHIFT)
    for r in range(_ROWS):
        te3, to3 = te[r:r + 3], to[r:r + 3]
        for phase in (0, 1):
            cur, nb = _neighbors(te3, to3, phase)
            ctx = torch.where(entry != 0, _sig_ctx_bulk(nb, entry),
                              _sig_ctx(nb))
            work = cur
            for i in range(n_planes):
                act = act_all[i]
                ptab = tabs[i]
                a_ref = ((work >> 31) == 1) & act
                work = ac.refine(a_ref, work, shift_all[i], pmask_all[i],
                                 ptab[13:14].expand(_LANES, n))
                insig = ((work >> 31) == 0) & act
                bits = ac.code(insig, (work >> shift_all[i]) & 1,
                               torch.gather(ptab[0:9], 0, ctx))
                newly = insig & (bits == 1)
                sctx = _sign_ctx(nb, pu_all[i])
                work = ac.sign_step(newly, work, sctx,
                                    torch.gather(ptab[9:13], 0, sctx >> 1),
                                    flag_all[i], pmask_all[i])
            _write_cells(te, to, r, phase, work)


def _code_blocks(te, to, ac: _Coder, msb, lut, ref_b, sig_b, sign_b,
                 cp_sig_b, cp_sign_b, k_over_l2, *, params: LUTParams,
                 wavelet_levels: int, coding_passes: int, has_k: bool,
                 n_planes: int) -> None:
    """Every pass of a batch, from plane n_planes - 1 down, as
    encode_blocks / decode_blocks schedule them (bpc_jax.py:697-754,
    789-847). With cp=3, each plane runs SPP and MRP below the block's MSB
    and CP at and below it, and k is ignored; with k > 0, the normal planes
    stop at the split plane and the bulk pass codes the rest."""
    bulk = has_k and coding_passes == 2
    if bulk:
        consec = split_plane(msb, k_over_l2)
        s_group = torch.minimum(consec, torch.clamp(msb, min=0))
        s_off = s_group * params.stride_per_group(wavelet_levels)
    else:
        consec = torch.zeros_like(msb)
        s_off = 0
    ref_b, sig_b, sign_b = (b.to(_I64) + s_off for b in (ref_b, sig_b, sign_b))
    probs = _prob_tables(lut, ref_b, sig_b, sign_b, n_planes)
    if coding_passes == 3:
        cp_probs = _prob_tables(lut, ref_b, cp_sig_b, cp_sign_b, n_planes)

    for plane in range(n_planes - 1, -1, -1):
        in_range = (plane <= msb)[None, :]
        if coding_passes == 2:
            act = in_range & (plane >= consec)[None, :]
            _spp_pass(te, to, ac, plane, act, probs[plane], False)
            _mrp_pass(te, to, ac, plane, act, probs[plane])
        else:
            spp_act = in_range & (plane < msb)[None, :]
            _spp_pass(te, to, ac, plane, spp_act, probs[plane], True)
            _mrp_pass(te, to, ac, plane, spp_act, probs[plane])
            _cp_pass(te, to, ac, plane, in_range, cp_probs[plane])

    if bulk:
        entry = torch.minimum(consec, torch.clamp(msb, min=0)) - 1
        entry = torch.where(consec > msb, msb, entry)
        # an empty block (msb -1) has entry -1: no bulk pass
        _bulk_pass(te, to, ac, torch.clamp(entry, min=0), entry >= 0, lut,
                   ref_b, sig_b, sign_b, n_planes)


# --------------------------------------------------------------------------
# Encode / decode
# --------------------------------------------------------------------------

def _block_msb(words: torch.Tensor, coding_passes: int) -> torch.Tensor:
    """Highest set magnitude bit per block, -1 for an empty block
    (findMSB; findMSB3CP masks the candidate bit, which `>> 1` moves to
    bit 29)."""
    mag = words >> 1
    if coding_passes == 3:
        mag = mag & ~_REF_BIT
    mag_max = mag.reshape(words.shape[0], -1).amax(dim=1)
    powers = torch.tensor([1 << k for k in range(32)], dtype=_I64,
                          device=words.device)
    return (mag_max[:, None] >= powers[None, :]).sum(dim=1) - 1


def encode_blocks_plain(blocks, lut, ref_b, sig_b, sign_b, cp_sig_b,
                        cp_sign_b, k_over_l2, *, params: LUTParams,
                        wavelet_levels: int, coding_passes: int, has_k: bool,
                        n_planes: int):
    """Encode (N, 64, 64) int32 codeblocks -> (streams (N, 4096) int32,
    sizes (N,) int32); byte-identical to
    `picsong_tpu.entropy.bpc_jax.encode_blocks` with the same arguments."""
    n = blocks.shape[0]
    b = blocks.to(_I64)
    words = (b.abs() << 1) | (b < 0).to(_I64)
    if coding_passes == 3:
        words = words | _CP_BIT
    msb = _block_msb(words, coding_passes)
    empty = msb < 0
    te, to = _to_grids(words)
    ac = _Coder(n, blocks.device, params.mult_precision)
    _code_blocks(te, to, ac, msb, lut, ref_b, sig_b, sign_b, cp_sig_b,
                 cp_sign_b, k_over_l2, params=params,
                 wavelet_levels=wavelet_levels, coding_passes=coding_passes,
                 has_k=has_k, n_planes=n_planes)

    # finish: every lane stores `low` at its reserved slot (slot 0 for a
    # lane that never reserved), then word 0 takes the MSB
    out = ac.out
    out.scatter_(1, ac.word.T, ac.low.T)
    out = out[:, :spec.CBLOCK_SIZE]
    out[:, 0] = torch.where(empty, 32, msb)
    sizes = torch.where(empty, 1, ac.counter + 1)
    raw = (sizes == spec.CBLOCK_SIZE)[:, None]
    out = torch.where(raw, _raw_layout(_from_grids(te, to)).to(_I64), out)
    return out.to(torch.int32), sizes.to(torch.int32)


def decode_blocks_plain(streams, sizes, lut, ref_b, sig_b, sign_b, cp_sig_b,
                        cp_sign_b, k_over_l2, *, params: LUTParams,
                        wavelet_levels: int, coding_passes: int, has_k: bool,
                        n_planes: int):
    """Decode (N, 4096) int32 streams -> (N, 64, 64) int32 coefficients;
    equal to `picsong_tpu.entropy.bpc_jax.decode_blocks` with the same
    arguments."""
    n = streams.shape[0]
    dev = streams.device
    is_raw = sizes.to(_I64) == spec.CBLOCK_SIZE
    msb_word = streams[:, 0].to(_I64)
    msb = torch.where((msb_word == 32) | is_raw, -1, msb_word)
    init = torch.zeros((n, _ROWS, _ROWS), dtype=_I64, device=dev)
    if coding_passes == 3:
        init = init | _CP_BIT     # initializeCoefficients3CP
    te, to = _to_grids(init)
    ac = _Coder(n, dev, params.mult_precision, streams)
    _code_blocks(te, to, ac, msb, lut, ref_b, sig_b, sign_b, cp_sig_b,
                 cp_sign_b, k_over_l2, params=params,
                 wavelet_levels=wavelet_levels, coding_passes=coding_passes,
                 has_k=has_k, n_planes=n_planes)

    words = _from_grids(te, to)
    words = torch.where(is_raw[:, None, None], _raw_unlayout(streams), words)
    mag = (words & spec.MAGNITUDE_MASK) >> 1
    return torch.where((words & 1) == 1, -mag, mag).to(torch.int32)
