"""Distribution over several devices: placement (`make_devices`), the
row-sharded single-image codec (`ShardedCodec`) and frame-data-parallel
video (`FrameParallelCodec`).

Counterpart of `picsong_tpu.dist.sharded`. There, GSPMD partitions one
program over a device mesh and inserts the halo exchanges and all-to-alls
itself (`sharded.py:84-97, 118-135`); here every exchange is an explicit
copy between shards, and each shard runs the single-device port's
kernels on its own device: the shard mode of X2 / X4
(`transform/dwt_cuda.py` `forward_shard` / `reverse_shard`, one launch a
shard and level for all the components, the prep and the finish fused as
on one device; the torch-op plain version on the CPU), the BPC kernels of
`entropy/bpc_cuda.py` and X3's pack and unpack.

The bytes are the contract, as in the JAX package (`sharded.py:21-22`):
every sharded codestream is byte-identical to the single-device port's,
and so to `TPUCodec`'s and the oracle's.

Row-sharded image (an RGB image's three components go together):

- *Row split.* Shard boundaries fall on multiples of max(64, 2**wl) rows
  of the adapted plane, so that every level splits on even rows; the
  units are shared out in contiguous, balanced spans, so a 1088-row plane
  (17 codeblock rows) splits 5/4/4/4 over 4 shards, and shards past the
  last unit hold no rows.
- *Upload.* Each shard uploads its rows of the mirror-padded samples.
- *Lifting with halos.* Each level's vertical pass reads neighbouring
  rows. A shard extends its input rows (the samples at level 0, where X2
  runs the prep on them: DC shift, RCT or ICT, all within a pixel) with a
  halo of its neighbours' (2 rows above and below for 5/3, 4 for 9/7;
  none at the plane's true top and bottom, where the edge rule applies as
  on one device) and runs `forward_shard`, which keeps its interior's
  band rows. The inverse reads its neighbours' band rows before the level
  (1 row a side for 5/3, 2 for 9/7, clipped at the plane) and runs
  `reverse_shard`, which re-lifts those halo rows itself and keeps its
  interior rows (at level 0 the finish's samples).
- *Deep levels.* Rule: from the first level at which a shard holds no
  more LL rows than the halo (a 256-row plane at wl=5 over 4 shards
  enters level 5 with 4 rows a shard, the 9/7 halo), the whole LL is
  gathered onto the first shard, which runs the remaining levels alone;
  the inverse runs those levels there, and the shards read their rows of
  its output back.
- *Tiling.* The codeblocks (64x64 tiles of the Mallat mosaic in warpID
  order) are shared out in contiguous, balanced spans of that order. A
  codeblock of level >= 1 holds rows that several shards computed, so
  each shard gathers the mosaic rows its blocks cover from the subband
  pieces of every shard (device-to-device copies) and tiles them. Decode
  is the mirror: each shard gathers the subband rows it needs from the
  decoded blocks of every shard.
- *Plane count.* The max over the shards' X2 coefficient maxima (each
  shard's taken over its levels): one read, as `TorchCodec.encode_planes`
  has.
- *Pack.* Each shard packs its own blocks on its device
  (`pack.pack_streams`) and downloads only the packed shorts; the host
  joins the shares into the codestream with `pack.join_frames`, and
  decode cuts it into shares with `pack.split_frames`.

The JAX package's `PICSONG_SHARDED_BPC` (mono or staged programs) and its
host plane bound with the `PlaneOverflowError` retry are TPU schedules and
are not ported (ROADMAP "Not ported, by design").
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from ..assembly import pack
from ..core import spec
from ..core.geometry import codeblocks_to_plane, plane_to_codeblocks
from ..core.header import CodecConfig, pack_header
from ..core.image_io import mirror_pad
from ..core.lut import LUTParams
from ..engine.batch import BatchCodec
from ..engine.pipeline import TorchCodec
from ..entropy import bpc, bpc_cuda
from ..transform import dwt, dwt_cuda

_CB = spec.CBLOCK_LENGTH


def make_devices(devices, device="cuda") -> list[torch.device]:
    """The shards' devices. `devices` is a sequence of devices, taken as
    given (a bare "cuda" is the current card), or a count N: on
    `device="cuda"` shard i goes to cuda:(i mod torch.cuda.device_count())
    (counted from the index of `device` if it names one), on "cpu" all N
    shards sit on the CPU. There is no CPU fallback for a CUDA request:
    without a card it raises."""
    if not isinstance(devices, int):
        out = [torch.device(d) for d in devices]
        out = [torch.device("cuda", torch.cuda.current_device())
               if d.type == "cuda" and d.index is None else d for d in out]
    else:
        base = torch.device(device)
        if devices < 1:
            raise ValueError(f"need at least one shard, got {devices}")
        if base.type == "cuda":
            if not torch.cuda.is_available():
                raise RuntimeError(f"{devices} shards on {device}: no CUDA "
                                   "device is available")
            count = torch.cuda.device_count()
            out = [torch.device("cuda", ((base.index or 0) + i) % count)
                   for i in range(devices)]
        else:
            out = [base] * devices
    if not out:
        raise ValueError("need at least one shard")
    return out


def placement(devices: Sequence[torch.device]) -> str:
    """Where the shards sit, for people: "2 shards on 1 card(s)
    (cuda:0, cuda:0)" or "2 shards on the CPU"."""
    devices = [torch.device(d) for d in devices]
    if all(d.type == "cpu" for d in devices):
        return f"{len(devices)} shards on the CPU"
    names = ", ".join(str(d) for d in devices)
    return (f"{len(devices)} shards on {len(set(devices))} card(s) "
            f"({names})")


def shares(n: int, parts: int) -> list[tuple[int, int]]:
    """`n` items in `parts` contiguous, balanced [start, stop) spans in
    order; the first n % parts spans hold one more, and spans past the
    n-th item are empty."""
    base, extra = divmod(n, parts)
    out, start = [], 0
    for i in range(parts):
        stop = start + base + (1 if i < extra else 0)
        out.append((start, stop))
        start = stop
    return out


def _assemble(pieces, r0: int, r1: int, c0: int, c1: int,
              device: torch.device) -> torch.Tensor:
    """The [r0, r1) x [c0, c1) window of a plane held as `pieces`, a list
    of (row, column, (..., rows, columns) tensor) rectangles that tile it,
    on `device`: each piece's overlap is copied in, across devices where it
    lies elsewhere."""
    first = pieces[0][2]
    out = torch.empty((*first.shape[:-2], r1 - r0, c1 - c0),
                      dtype=first.dtype, device=device)
    for pr, pc, t in pieces:
        h, w = t.shape[-2:]
        a, b = max(r0, pr), min(r1, pr + h)
        c, d = max(c0, pc), min(c1, pc + w)
        if a < b and c < d:
            out[..., a - r0:b - r0, c - c0:d - c0].copy_(
                t[..., a - pr:b - pr, c - pc:d - pc])
    return out


def _extend(parts: list[tuple[torch.Tensor, ...]], k: int):
    """Each part (a tuple of row-aligned (..., rows, columns) tensors on
    one device, in plane order) with `k` rows of its neighbours above and
    below, none at the plane's top and bottom -> [(extended tuple, rows
    above)]."""
    out = []
    for i, part in enumerate(parts):
        top = k if i > 0 else 0
        bottom = k if i < len(parts) - 1 else 0
        ext = []
        for j, t in enumerate(part):
            rows = [t]
            if top:
                rows.insert(0, parts[i - 1][j][..., -k:, :].to(t.device))
            if bottom:
                rows.append(parts[i + 1][j][..., :k, :].to(t.device))
            ext.append(torch.cat(rows, dim=-2) if len(rows) > 1 else t)
        out.append((tuple(ext), top))
    return out


class ShardedCodec:
    """Row-sharded single-image codec over `devices` (see the module
    docstring): `encode` / `decode` as `TorchCodec`'s, byte for byte, and
    `encode_plane` / `decode_plane` on one DC-shifted component plane."""

    def __init__(self, cfg: CodecConfig, luts, params: LUTParams,
                 devices: Sequence):
        self.cfg = cfg
        self.params = params
        self.devices = make_devices(devices)
        # one TorchCodec a distinct device: its prep and finish, its LUTs
        # and per-block metadata there
        self._codecs = {d: TorchCodec(cfg, luts, params, d)
                        for d in dict.fromkeys(self.devices)}
        first = self._codecs[self.devices[0]]
        self.aw, self.ah, self.ncb = first.aw, first.ah, first.ncb
        self.dtype = first.dtype
        levels = cfg.wavelet_levels
        dwt._check((self.ah, self.aw), levels)
        n = len(self.devices)
        unit = max(_CB, 1 << levels)
        self.rows = [(a * unit, b * unit)
                     for a, b in shares(self.ah // unit, n)]
        # the shards that hold codeblocks: (shard, first block, end)
        self.blocks = [(s, b0, b1) for s, (b0, b1)
                       in enumerate(shares(self.ncb, n)) if b1 > b0]
        self._counts = [b1 - b0 for _, b0, b1 in self.blocks]
        self._halo = 4 if cfg.is_lossy else 2
        self._plan = self._level_plan()
        self._meta = {s: tuple(m[b0:b1] for m in self._codec(s)._meta)
                      for s, b0, b1 in self.blocks}
        self._kw = first._bpc_kw

    @property
    def n_components(self) -> int:
        return 3 if self.cfg.is_rgb else 1

    def _codec(self, shard: int) -> TorchCodec:
        return self._codecs[self.devices[shard]]

    def _level_plan(self) -> list[list[tuple[int, int, int]]]:
        """Per level, the (shard, first row, end) spans of the rows of the
        level's input LL (the plane at level 0) each shard holds; one span
        on the first shard from the deep-level gather on."""
        spans = [(s, r0, r1) for s, (r0, r1) in enumerate(self.rows)
                 if r1 > r0]
        plan = []
        for level in range(self.cfg.wavelet_levels):
            if len(spans) > 1 and min(r1 - r0 for _, r0, r1 in spans) \
                    <= self._halo:
                spans = [(spans[0][0], 0, self.ah >> level)]
            plan.append(spans)
            spans = [(s, r0 // 2, r1 // 2) for s, r0, r1 in spans]
        return plan

    # -- the sharded device steps -----------------------------------------

    def _forward(self, parts: list[list[torch.Tensor]]):
        """Per level-0 span its rows of the component planes (the sample
        planes, or one DC-shifted int32 / float32 plane) -> (the quantized
        subbands as (row, column, (comps, rows, columns) int32 tensor)
        pieces of the Mallat mosaic, on the shards that computed them; per
        shard that ran a level, the maximum magnitude over its levels)."""
        cfg = self.cfg
        pieces, tops = [], {}
        cur = [tuple(p) for p in parts]     # per span: its input planes
        rows = [r0 for _, r0, _ in self._plan[0]]
        for level, spans in enumerate(self._plan):
            h2, w2 = self.ah >> (level + 1), self.aw >> (level + 1)
            if len(spans) < len(cur):           # the deep-level gather
                cur = [(_assemble([(r, 0, t) for r, (t,) in zip(rows, cur)],
                                  0, 2 * h2, 0, 2 * w2,
                                  self.devices[spans[0][0]]),)]
            nxt = []
            for (x, top), (s, r0, r1) in zip(_extend(cur, self._halo),
                                             spans):
                planes = list(x) if level == 0 else list(x[0].unbind(0))
                (ll, hl, lh, hh), tops[s] = dwt_cuda.forward_shard(
                    planes, cfg, level, r0 - top, r0, r1, tops.get(s))
                r = r0 // 2
                pieces += [(r, w2, hl), (h2 + r, 0, lh), (h2 + r, w2, hh)]
                nxt.append((ll,))
            cur, rows = nxt, [r0 // 2 for _, r0, _ in spans]
        pieces += [(r, 0, t) for r, (t,) in zip(rows, cur)]
        return pieces, list(tops.values())

    def _tile(self, pieces) -> list[torch.Tensor]:
        """Subband pieces -> each codeblock shard's (comps, n, 64, 64)
        blocks: the mosaic rows of its blocks gathered onto its device and
        tiled."""
        bx = self.aw // _CB
        out = []
        for s, b0, b1 in self.blocks:
            y0, y1 = b0 // bx, -(-b1 // bx)
            slab = _assemble(pieces, y0 * _CB, y1 * _CB, 0, self.aw,
                             self.devices[s])
            out.append(plane_to_codeblocks(slab)[
                :, b0 - y0 * bx:b1 - y0 * bx].contiguous())
        return out

    def _untile(self, blocks: list[torch.Tensor]) -> list[tuple]:
        """Each codeblock shard's decoded (comps, n, 64, 64) blocks ->
        (row, column, (comps, rows, columns) tensor) pieces of the mosaic: a
        partial first block row, the whole rows, a partial last row."""
        bx = self.aw // _CB
        pieces = []
        for (_, b0, b1), t in zip(self.blocks, blocks):
            nc = t.shape[0]
            i = b0
            while i < b1:
                y, x = divmod(i, bx)
                if x or b1 - i < bx:            # a partial block row
                    j = min(b1, (y + 1) * bx)
                    pieces.append((y * _CB, x * _CB, t[:, i - b0:j - b0]
                                   .transpose(1, 2).reshape(nc, _CB, -1)))
                else:                           # whole block rows
                    j = i + (b1 - i) // bx * bx
                    pieces.append((y * _CB, 0, codeblocks_to_plane(
                        t[:, i - b0:j - b0], (j - i) // bx * _CB, self.aw)))
                i = j
        return pieces

    def _inverse(self, pieces, to_samples: bool = True) -> list[torch.Tensor]:
        """Mosaic pieces of the components -> per level-0 span its
        (comps, rows, aw) rows: the finish's samples, or without
        `to_samples` the reconstructed plane (int32 for 5/3, float32 for
        9/7). Each shard reads its band rows and its neighbours' halo, HALO
        / 2 band rows a side, before the level."""
        k = self._halo // 2
        ll_pieces = pieces          # the deepest LL: the mosaic's corner
        for level in range(self.cfg.wavelet_levels - 1, -1, -1):
            h2, w2 = self.ah >> (level + 1), self.aw >> (level + 1)
            out = []
            for s, r0, r1 in self._plan[level]:
                dev = self.devices[s]
                b0, b1 = max(r0 // 2 - k, 0), min(r1 // 2 + k, h2)
                bands = (_assemble(ll_pieces, b0, b1, 0, w2, dev),
                         _assemble(pieces, b0, b1, w2, 2 * w2, dev),
                         _assemble(pieces, h2 + b0, h2 + b1, 0, w2, dev),
                         _assemble(pieces, h2 + b0, h2 + b1, w2, 2 * w2,
                                   dev))
                out.append((r0, dwt_cuda.reverse_shard(
                    bands, self.cfg, level, b0, r0, r1, to_samples)))
            ll_pieces = [(r, 0, t) for r, t in out]
        return [t for _, t in out]

    def _bpc_args(self, shard: int, component: int):
        luts = self._codec(shard).luts
        return (luts[min(component, len(luts) - 1)], *self._meta[shard])

    def _encode_blocks(self, blocks, n_planes: int, component: int):
        """BPC encode of each codeblock shard's blocks on its device, one
        launch a shard -> [(streams, sizes)]."""
        return [bpc_cuda.encode_blocks(b, *self._bpc_args(s, component),
                                       **self._kw, n_planes=n_planes)
                for (s, _, _), b in zip(self.blocks, blocks)]

    def _decode_blocks(self, coded, n_planes: int, component: int):
        return [bpc_cuda.decode_blocks(st, z, *self._bpc_args(s, component),
                                       **self._kw, n_planes=n_planes)
                for (s, _, _), (st, z) in zip(self.blocks, coded)]

    def _n_planes(self, tops) -> int:
        """The bitplane count from the shards' coefficient maxima (0-dim
        tensors): one read of their max."""
        first = self.devices[self.blocks[0][0]]
        top = torch.stack([t.to(first) for t in tops]).amax()
        return bpc.planes_for_magnitude(int(top))

    def _upload_rows(self, plane: np.ndarray) -> list[torch.Tensor]:
        return [torch.from_numpy(np.ascontiguousarray(plane[r0:r1]))
                .to(self.devices[s]) for s, r0, r1 in self._plan[0]]

    # -- host-facing API (TorchCodec's and the JAX ShardedCodec's) --------

    def encode_plane(self, plane_shifted, n_planes: int | None = None,
                     lut_index: int = 0):
        """One DC-shifted (ah, aw) component plane on the host (int32, or
        float32 for 9/7) -> ((ncb, 4096) int32 streams, (ncb,) sizes) on
        the host. n_planes None reads the coefficient maximum."""
        pieces, tops = self._forward([[t] for t in self._upload_rows(
            np.asarray(plane_shifted))])
        blocks = [b[0] for b in self._tile(pieces)]
        if n_planes is None:
            n_planes = self._n_planes(tops)
        coded = self._encode_blocks(blocks, n_planes, lut_index)
        return (np.concatenate([st.cpu().numpy() for st, _ in coded]),
                np.concatenate([z.cpu().numpy() for _, z in coded]))

    def decode_plane(self, streams, sizes, lut_index: int = 0) -> np.ndarray:
        """(ncb, 4096) streams + (ncb,) sizes on the host -> the
        reconstructed (ah, aw) component plane on the host."""
        streams = np.asarray(streams, dtype=np.int32)
        sizes = np.asarray(sizes, dtype=np.int32)
        n_planes = bpc.planes_for_streams(streams[:, 0], sizes)
        coded = [(torch.from_numpy(streams[b0:b1]).to(self.devices[s]),
                  torch.from_numpy(sizes[b0:b1]).to(self.devices[s]))
                 for s, b0, b1 in self.blocks]
        rows = self._inverse(self._untile(
            [b[None] for b in self._decode_blocks(coded, n_planes,
                                                  lut_index)]), False)
        return np.concatenate([r[0].cpu().numpy() for r in rows])

    def upload(self, pixels) -> list[list[torch.Tensor]]:
        """(height, width) samples (gray) or [R, G, B] planes on the host ->
        per level-0 span, its rows of the mirror-padded planes on its
        shard's device."""
        planes = pixels if self.cfg.is_rgb else [pixels]
        if len(planes) != self.n_components:
            raise ValueError(f"expected {self.n_components} sample planes, "
                             f"got {len(planes)}")
        padded = [self._upload_rows(mirror_pad(
            np.asarray(p).astype(self.dtype, copy=False), self.aw, self.ah))
            for p in planes]
        return [[p[k] for p in padded] for k in range(len(self._plan[0]))]

    def tile_planes(self, samples: list[list[torch.Tensor]]):
        """The sharded X2 (prep, DWT, quantization) and the tiling:
        `upload`'s rows -> (per component, each codeblock shard's (n, 64,
        64) int32 codeblocks on its device; the shards' coefficient
        maxima)."""
        pieces, tops = self._forward(samples)
        blocks = self._tile(pieces)
        return ([[b[i] for b in blocks] for i in range(self.n_components)],
                tops)

    def encode_planes(self, samples: list[list[torch.Tensor]]):
        """Device half of encode (`TorchCodec.encode_planes` sharded):
        `upload`'s rows -> (per component, each codeblock shard's
        (streams, sizes) on its device; n_planes). Reads one scalar, the
        coefficient maximum over all shards and components."""
        blocks, tops = self.tile_planes(samples)
        n_planes = self._n_planes(tops)
        return ([self._encode_blocks(comp, n_planes, i)
                 for i, comp in enumerate(blocks)], n_planes)

    def decode_planes(self, coded) -> list[list[torch.Tensor]]:
        """Device half of decode: per component (each codeblock shard's
        (streams, int32 sizes) on its device, n_planes) -> per level-0
        span, its rows of the sample planes (one gray or [R, G, B]): the
        sharded X4 (dequantization, inverse DWT, finish)."""
        comps = [self._decode_blocks(shards, n_planes, i)
                 for i, (shards, n_planes) in enumerate(coded)]
        blocks = [torch.stack(c) if len(c) > 1 else c[0][None]
                  for c in zip(*comps)]
        return [list(t.unbind(0))
                for t in self._inverse(self._untile(blocks))]

    def encode(self, pixels) -> list[np.ndarray]:
        """(height, width) samples (gray) or [R, G, B] planes -> one packed
        uint16 codestream per component, the header on the first: each
        shard packs its codeblocks, the host joins the shares."""
        coded, n_planes = self.encode_planes(self.upload(pixels))
        out = []
        for i, shards in enumerate(coded):
            parts = [pack.pack_streams(st, z, None).cpu().numpy()
                     .view(np.uint16) for st, z in shards]
            shorts, msb, z = pack.join_frames(
                parts, self._counts, pack_header(self.cfg) if i == 0
                else None)
            bpc.check_planes_bound(msb, z, n_planes)
            out.append(shorts)
        return out

    def decode(self, component_streams: list[np.ndarray]):
        """One packed codestream per component -> samples cropped to
        (height, width): one plane (gray) or [R, G, B]. The host cuts each
        codestream into the shards' shares; each shard unpacks its own."""
        if len(component_streams) != self.n_components:
            raise ValueError(f"expected {self.n_components} component "
                             f"codestreams, got {len(component_streams)}")
        coded = []
        for shorts in component_streams:
            shorts = np.ascontiguousarray(shorts, dtype=np.uint16)
            msb, sizes = pack.block_fields(shorts, self.ncb)
            parts = pack.split_frames(shorts, len(self.blocks), self._counts,
                                      None)
            coded.append(([pack.unpack_streams(
                torch.from_numpy(part.view(np.int16)).to(self.devices[s]),
                b1 - b0, int(sizes[b0:b1].sum()) - (b1 - b0))
                for (s, b0, b1), part in zip(self.blocks, parts)],
                bpc.planes_for_streams(msb, sizes)))
        rows = [[p.cpu().numpy() for p in span]
                for span in self.decode_planes(coded)]
        planes = [np.concatenate([r[i] for r in rows])
                  [:self.cfg.height, :self.cfg.width]
                  for i in range(self.n_components)]
        return planes if self.cfg.is_rgb else planes[0]


class FrameParallelCodec:
    """Frame-data-parallel video codec: a batch of B frames in N contiguous
    shares of B / N frames, one `BatchCodec` on each of N devices (with one
    BPC launch per component and share). `engine/video.py` drives the
    shares through its pipeline; `encode_batch` / `decode_batch` are the
    synchronous form of one batch (the JAX FrameParallelCodec's)."""

    def __init__(self, cfg: CodecConfig, luts, params: LUTParams,
                 devices: Sequence, batch: int | None = None):
        self.cfg = cfg
        self.devices = make_devices(devices)
        n = len(self.devices)
        self.batch = batch or n
        if self.batch % n:
            raise ValueError(f"batch {self.batch} is not a multiple of "
                             f"{n} devices")
        self.share = self.batch // n
        self.codecs = [BatchCodec(cfg, luts, params, self.share, d)
                       for d in self.devices]
        self.aw, self.ah = self.codecs[0].aw, self.codecs[0].ah
        self.ncb = self.codecs[0].ncb

    def encode_batch(self, frames) -> list[tuple[np.ndarray, np.ndarray]]:
        """(B, ah, aw) or (B, 3, ah, aw) padded frames on the host -> per
        component ((B, ncb, 4096) int32 streams, (B, ncb) sizes) on the
        host; one bitplane count over the batch."""
        frames = np.asarray(frames)
        staged = [bc.prep_batch(torch.from_numpy(np.ascontiguousarray(
            frames[j * self.share:(j + 1) * self.share])).to(bc.device))
            for j, bc in enumerate(self.codecs)]
        first = self.devices[0]
        n_planes = bpc.planes_for_magnitude(int(torch.stack(
            [m.to(first) for _, m in staged]).amax()))
        coded = [bc.encode_blocks(blocks, n_planes)
                 for bc, (blocks, _) in zip(self.codecs, staged)]
        return [(np.concatenate([c[i][0].cpu().numpy() for c in coded])
                 .reshape(self.batch, self.ncb, -1),
                 np.concatenate([c[i][1].cpu().numpy() for c in coded])
                 .reshape(self.batch, self.ncb))
                for i in range(len(coded[0]))]

    def decode_batch(self, coded) -> np.ndarray:
        """Per component ((B, ncb, 4096) streams, (B, ncb) sizes) on the
        host -> the decoded (B, ah, aw) or (B, 3, ah, aw) samples."""
        coded = [(np.asarray(s, np.int32), np.asarray(z, np.int32))
                 for s, z in coded]
        n_planes = max(bpc.planes_for_streams(s[..., 0].reshape(-1),
                                              z.reshape(-1))
                       for s, z in coded)
        out = []
        for j, bc in enumerate(self.codecs):
            f = slice(j * self.share, (j + 1) * self.share)
            mine = [(torch.from_numpy(np.ascontiguousarray(
                s[f].reshape(-1, spec.CBLOCK_SIZE))).to(bc.device),
                torch.from_numpy(np.ascontiguousarray(z[f].reshape(-1)))
                .to(bc.device)) for s, z in coded]
            out.append(bc.decode_batch(mine, n_planes).cpu().numpy())
        return np.concatenate(out)
