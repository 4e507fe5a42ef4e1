"""Plain BPC-PaCo, two coding passes, k = 0: the reference coder.

Torch ops over (32, N) tensors, 32 warp lanes by N codeblocks, one loop
step per (bitplane, pass, row, phase): significance propagation (SPP) and
magnitude refinement (MRP) from each block's own MSB down, a 16-bit
arithmetic coder a lane, slots reserved in ascending lane order at
min(rank + counter, 4094) + 1. Word 0 of a block's stream holds its MSB
(32 for an empty block), unwritten slots hold -1, the size is the slot
counter + 1, and a block whose size reaches 4096 becomes a raw lane-major
copy of its words.

Coefficient words are (|v| << 1) | sign plus state flags: the plane of
significance in bits 24-28, refinement in bit 29, significance in bit 31;
int64 so that bit 31 reads as a plain positive bit.

Each block names its LUT by its bases into one concatenation of the
tables, and its reads are clipped into its own table, so one call codes
the blocks of several components and images.
"""

from __future__ import annotations

import torch

LANES = 32
ROWS = 64
BLOCK = 4096
AC_INTERVAL_INIT = (1 << 16) - 1
MAX_RESERVED_SLOT = 4094
MAX_SLOT_COUNT = 4095
BITPLANE_SHIFT = 24
MAGNITUDE_MASK = 0xFFFFFF
_SIG_BIT = 1 << 31
_REF_BIT = 1 << 29
_I64 = torch.int64


# --------------------------------------------------------------------------
# Layouts: (N, 64, 64) words <-> even/odd column grids (66, 33, N)
# --------------------------------------------------------------------------

def _to_grids(words: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Even and odd columns, each with a one-cell zero border: te[1 + r, l]
    is word[r, 2l], to[1 + r, l + 1] is word[r, 2l + 1]."""
    n = words.shape[0]
    te = torch.zeros((ROWS + 2, LANES + 1, n), dtype=_I64,
                     device=words.device)
    to = torch.zeros_like(te)
    pairs = words.to(_I64).reshape(n, ROWS, LANES, 2).permute(1, 2, 3, 0)
    te[1:-1, :LANES, :] = pairs[:, :, 0, :]
    to[1:-1, 1:, :] = pairs[:, :, 1, :]
    return te, to


def _from_grids(te: torch.Tensor, to: torch.Tensor) -> torch.Tensor:
    n = te.shape[-1]
    pairs = torch.stack([te[1:-1, :LANES, :], to[1:-1, 1:, :]], dim=2)
    return pairs.permute(3, 0, 1, 2).reshape(n, ROWS, ROWS)


def _raw_layout(words: torch.Tensor) -> torch.Tensor:
    """(N, 64, 64) words -> (N, 4096) lane-major low-16 copy:
    out[lane*128 + row*2 + parity] = word[row, lane*2 + parity]."""
    n = words.shape[0]
    v = words & 0xFFFF
    return v.reshape(n, ROWS, LANES, 2).permute(0, 2, 1, 3).reshape(n, -1)


def _raw_unlayout(cs: torch.Tensor) -> torch.Tensor:
    n = cs.shape[0]
    v = cs.to(_I64) & 0xFFFF
    return v.reshape(n, LANES, ROWS, 2).permute(0, 2, 1, 3).reshape(
        n, ROWS, ROWS)


def _prob_tables(lut, lo, hi, ref_b, sig_b, sign_b,
                 n_planes: int) -> torch.Tensor:
    """(n_planes, 16, N) probabilities: rows 0-8 significance contexts,
    9-12 sign contexts, 13 refinement, 14-15 padding; each read clipped
    into the block's own table [lo, hi]."""
    n = ref_b.shape[0]
    dev = lut.device
    p = torch.arange(n_planes, dtype=_I64, device=dev)[:, None, None]
    lo, hi = lo[None, None, :], hi[None, None, :]

    def read(base, n_ctx):
        i = torch.arange(n_ctx, dtype=_I64, device=dev)[None, :, None]
        idx = base[None, None, :] + p * n_ctx + i
        return lut[torch.minimum(torch.maximum(idx, lo), hi)]

    pad = torch.full((n_planes, 2, n), 64, dtype=_I64, device=dev)
    return torch.cat([read(sig_b, 9), read(sign_b, 4), read(ref_b, 1), pad],
                     dim=1)


# --------------------------------------------------------------------------
# Contexts
# --------------------------------------------------------------------------

def _neighbors(te3, to3, phase: int):
    """Current cells and 8-neighbourhood, (32, N) each, for one phase."""
    if phase == 0:
        cur = te3[1, :LANES, :]
        nb = dict(ul=to3[0, :LANES, :], up=te3[0, :LANES, :],
                  ur=to3[0, 1:, :], lf=to3[1, :LANES, :], rt=to3[1, 1:, :],
                  bl=to3[2, :LANES, :], bt=te3[2, :LANES, :],
                  br=to3[2, 1:, :])
    else:
        cur = to3[1, 1:, :]
        nb = dict(ul=te3[0, :LANES, :], up=to3[0, 1:, :], ur=te3[0, 1:, :],
                  lf=te3[1, :LANES, :], rt=te3[1, 1:, :],
                  bl=te3[2, :LANES, :], bt=to3[2, 1:, :], br=te3[2, 1:, :])
    return cur, nb


def _sig_ctx(nb) -> torch.Tensor:
    return sum((v >> 31) for v in nb.values())


def _sign_ctx(nb) -> torch.Tensor:
    """Sign context code, the expected sign in bit 0."""

    def c(v):
        return torch.where((v >> 31) != 0, torch.where((v & 1) == 1, -1, 1), 0)

    h = c(nb["lf"]) + c(nb["rt"])
    v = c(nb["up"]) + c(nb["bt"])
    out = torch.zeros_like(h)
    out = torch.where((h == 0) & (v > 0), 2, out)
    out = torch.where((h == 0) & (v < 0), 3, out)
    out = torch.where((h > 0) & (v == 0), 4, out)
    out = torch.where((h > 0) & (v > 0), 6, out)
    out = torch.where((h < 0) & (v == 0), 5, out)
    out = torch.where((h < 0) & (v > 0), 1, out)
    out = torch.where((h < 0) & (v < 0), 7, out)
    return out


def _write_cells(te, to, r: int, phase: int, vals) -> None:
    if phase == 0:
        te[r + 1, :LANES, :] = vals
    else:
        to[r + 1, 1:, :] = vals


def _plane_mask(plane: int) -> int:
    """The decoder's approximation mask at a plane."""
    return (3 << plane) if plane >= 1 else 2


# --------------------------------------------------------------------------
# The 32-lane arithmetic coder over (32, N) state
# --------------------------------------------------------------------------

class _Coder:
    """Per-lane interval state and the per-block slot counter; an encoder
    (writing `out`) or, given `streams`, a decoder. `word` is the reserved
    slot on encode and the current codeword on decode."""

    def __init__(self, n: int, device, prec: int, streams=None):
        z = torch.zeros((LANES, n), dtype=_I64, device=device)
        self.low, self.size, self.word = z, z.clone(), z.clone()
        self.counter = torch.zeros(n, dtype=_I64, device=device)
        self.prec = prec
        self.encoding = streams is None
        if self.encoding:
            # column 4096 is a sink for the lanes that store nothing
            self.out = torch.full((n, BLOCK + 1), -1, dtype=_I64,
                                  device=device)
        else:
            self.streams_u = streams.to(_I64) & 0xFFFFFFFF

    def _reserve(self, need):
        needi = need.to(_I64)
        rank = torch.cumsum(needi, dim=0) - needi
        nslot = torch.clamp(rank + self.counter, max=MAX_RESERVED_SLOT) + 1
        self.counter = torch.clamp(self.counter + needi.sum(dim=0),
                                   max=MAX_SLOT_COUNT)
        self.low = torch.where(need, 0, self.low)
        self.size = torch.where(need, AC_INTERVAL_INIT, self.size)
        return nslot

    def code(self, active, bits, probs) -> torch.Tensor:
        """One coding step of the `active` lanes: encodes `bits` and returns
        them, or decodes and returns the symbols."""
        need = active & (self.size == 0)
        nslot = self._reserve(need)
        if self.encoding:
            self.word = torch.where(need, nslot, self.word)
            aux = ((self.size * probs) >> self.prec) + bits
            one = active & (bits == 1)
            zero = active & (bits == 0)
            self.size = torch.where(zero, aux,
                                    torch.where(one, self.size - aux,
                                                self.size))
            self.low = torch.where(one, self.low + aux, self.low)
            flush = active & (self.size == 0)
            slot = torch.where(flush, self.word, BLOCK)
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


# --------------------------------------------------------------------------
# The two passes, a 64-row x 2-phase scan each
# --------------------------------------------------------------------------

def _spp_pass(te, to, ac: _Coder, plane: int, act, ptab) -> None:
    shift = plane + 1
    flag = _SIG_BIT | (plane << BITPLANE_SHIFT)
    pmask = _plane_mask(plane)
    for r in range(ROWS):
        te3, to3 = te[r:r + 3], to[r:r + 3]
        for phase in (0, 1):
            cur, nb = _neighbors(te3, to3, phase)
            active = ((cur >> 31) == 0) & act
            bits = ac.code(active, (cur >> shift) & 1,
                           torch.gather(ptab[0:9], 0, _sig_ctx(nb)))
            newly = active & (bits == 1)
            sctx = _sign_ctx(nb)
            ssym = ac.code(newly, torch.where((cur & 1) == (sctx & 1), 0, 1),
                           torch.gather(ptab[9:13], 0, sctx >> 1))
            if ac.encoding:
                upd = torch.where(newly, cur | flag, cur)
            else:
                sbit = torch.where((ssym & 1) == (sctx & 1), 0, 1)
                upd = torch.where(newly, cur | pmask | flag | sbit, cur)
            _write_cells(te, to, r, phase, upd)


def _mrp_pass(te, to, ac: _Coder, plane: int, act, ptab) -> None:
    shift = plane + 1
    pmask = _plane_mask(plane)
    ref_prob = ptab[13:14].expand(LANES, -1)
    for r in range(ROWS):
        for phase in (0, 1):
            cur = te[r + 1, :LANES] if phase == 0 else to[r + 1, 1:]
            refine = ((cur >> 29) & 1) == 1
            active = refine & act
            eligible = ~refine & ((cur >> 31) == 1) & act
            sym = ac.code(active, (cur >> shift) & 1, ref_prob)
            upd = cur
            if not ac.encoding:
                patt = ((sym << 1) + 1) << (shift - 1)
                upd = torch.where(active, (cur & ~pmask) | (pmask & patt), cur)
            _write_cells(te, to, r, phase,
                         torch.where(eligible, upd | _REF_BIT, upd))


def _code(te, to, ac: _Coder, msb, lut, lo, hi, ref_b, sig_b, sign_b,
          n_planes: int) -> None:
    probs = _prob_tables(lut, lo, hi, ref_b, sig_b, sign_b, n_planes)
    for plane in range(n_planes - 1, -1, -1):
        act = (plane <= msb)[None, :]
        _spp_pass(te, to, ac, plane, act, probs[plane])
        _mrp_pass(te, to, ac, plane, act, probs[plane])


def block_msb(blocks: torch.Tensor) -> torch.Tensor:
    """Highest set magnitude bit a block, -1 for an empty block."""
    mag = blocks.to(_I64).abs().reshape(blocks.shape[0], -1).amax(dim=1)
    powers = 2 ** torch.arange(32, dtype=_I64, device=blocks.device)
    return (mag[:, None] >= powers[None, :]).sum(dim=1) - 1


def planes_needed(msb: torch.Tensor) -> int:
    return max(int(msb.max()) + 1, 1) if msb.numel() else 1


class Tables:
    """The LUTs concatenated, and each block's bases and bounds in them."""

    def __init__(self, luts: list[torch.Tensor], table: torch.Tensor,
                 ref_b, sig_b, sign_b, prec: int):
        lens = torch.tensor([t.numel() for t in luts], dtype=_I64,
                            device=table.device)
        starts = torch.cumsum(lens, 0) - lens
        self.lut = torch.cat(luts).to(_I64)
        self.lo = starts[table]
        self.hi = self.lo + lens[table] - 1
        self.bases = tuple(b.to(_I64) + self.lo for b in (ref_b, sig_b,
                                                          sign_b))
        self.prec = prec


def encode_blocks(blocks: torch.Tensor, tables: Tables):
    """(N, 64, 64) int32 coefficients -> (streams (N, 4096) int32, sizes
    (N,) int32)."""
    n = blocks.shape[0]
    b = blocks.to(_I64)
    words = (b.abs() << 1) | (b < 0).to(_I64)
    msb = block_msb(blocks)
    empty = msb < 0
    te, to = _to_grids(words)
    ac = _Coder(n, blocks.device, tables.prec)
    _code(te, to, ac, msb, tables.lut, tables.lo, tables.hi, *tables.bases,
          planes_needed(msb))
    out = ac.out
    # every lane stores `low` at its reserved slot (slot 0 for a lane that
    # never reserved), then word 0 takes the MSB
    out.scatter_(1, ac.word.T, ac.low.T)
    out = out[:, :BLOCK]
    out[:, 0] = torch.where(empty, 32, msb)
    sizes = torch.where(empty, 1, ac.counter + 1)
    raw = (sizes == BLOCK)[:, None]
    out = torch.where(raw, _raw_layout(_from_grids(te, to)), out)
    return out.to(torch.int32), sizes.to(torch.int32)


def decode_blocks(streams: torch.Tensor, sizes: torch.Tensor,
                  tables: Tables) -> torch.Tensor:
    """(N, 4096) int32 streams and (N,) sizes -> (N, 64, 64) int32."""
    n = streams.shape[0]
    dev = streams.device
    is_raw = sizes.to(_I64) == BLOCK
    msb_word = streams[:, 0].to(_I64)
    msb = torch.where((msb_word == 32) | is_raw, -1, msb_word)
    te, to = _to_grids(torch.zeros((n, ROWS, ROWS), dtype=_I64, device=dev))
    ac = _Coder(n, dev, tables.prec, streams)
    _code(te, to, ac, msb, tables.lut, tables.lo, tables.hi, *tables.bases,
          planes_needed(msb))
    words = _from_grids(te, to)
    words = torch.where(is_raw[:, None, None], _raw_unlayout(streams), words)
    mag = (words & MAGNITUDE_MASK) >> 1
    return torch.where((words & 1) == 1, -mag, mag).to(torch.int32)
