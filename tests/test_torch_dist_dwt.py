"""The shard mode of X2 / X4 (`transform/dwt_cuda.py` `forward_shard` /
`reverse_shard`), the transforms `ShardedCodec` runs a shard and level at a
time, on the CPU (its plain version, the torch ops): every shard's band
rows against the JAX package's whole-plane `dwt_forward`, every shard's
rows back against its `dwt_reverse`, and a NumPy model of the kernels'
row mapping in shard mode (the buffer rows a tile reads, where the edge
rule fires, the rows it stores).

Tolerances: none on the integer paths (5/3, RCT). On 9/7 the shard mode
is exact against the NumPy oracle (`reference/dwt.py`); against JAX on
XLA:CPU, whose fused float ops drift (ROADMAP queue 3, 3 of 262144
coefficients at 512^2 wl=3 qs 1), the quantized coefficients may differ
by +-1 in at most 1e-4 of the positions at 8 bits (as
tests/test_torch_lossy.py; 16-bit coefficients are larger, so only the
+-1 holds there), and the reconstruction stays within 0.05 dB of JAX's
(PSNR against the input).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from picsong_tpu.reference import dwt as odwt
from picsong_tpu.transform import dwt as jdwt
from picsong_tpu_torch.core.header import CodecConfig
from picsong_tpu_torch.core.image_io import mirror_pad
from picsong_tpu_torch.core.lut import LUTParams, neutral_lut
from picsong_tpu_torch.dist.sharded import ShardedCodec
from picsong_tpu_torch.transform import dwt, dwt_cuda
from test_torch_dwt_cuda import _lift_strips, _x2_steps, _x4_steps

PARAMS = LUTParams()
H, W = 256, 128

WAVELETS = [("5/3", False, 1.0), ("9/7 qs 1", True, 1.0),
            ("9/7 qs 0.5", True, 0.5)]
# (shards, wavelet, wl, rgb, bits, width, height)
CASES = [(n, wav, wl, False, 8, W, H) for n in (2, 3, 4)
         for wav in WAVELETS for wl in (1, 2, 3, 4, 5)]
CASES += [
    (3, WAVELETS[0], 3, True, 8, W, H),           # RCT
    (2, WAVELETS[1], 5, True, 8, W, H),           # ICT
    (4, WAVELETS[2], 2, True, 8, W, H),
    (3, WAVELETS[0], 5, False, 16, W, H),         # 16-bit
    (2, WAVELETS[1], 4, False, 16, W, H),
    (4, WAVELETS[0], 5, False, 8, 1920, 1080),    # rows 320/256/256/256
    (4, WAVELETS[1], 5, False, 8, 1920, 1080),
    (4, WAVELETS[0], 6, False, 8, 512, 256),      # gathered from level 5
]


def _case_id(case):
    n, (wav, _, _), wl, rgb, bits, w, h = case
    kind = ("RGB " if rgb else "") + (f"{bits}-bit " if bits > 8 else "")
    return f"{w}x{h} {kind}{wav} wl={wl} x{n}"


def _setup(case):
    """(cfg, the sample planes (adapted size), the codec on CPU shards, the
    whole planes after the prep)."""
    n, (_, lossy, qs), wl, rgb, bits, w, h = case
    cfg = CodecConfig(width=w, height=h, wavelet_levels=wl, is_lossy=lossy,
                      qs=qs, is_rgb=rgb, components=3 if rgb else 1,
                      bit_depth=bits, bps=bits)
    rng = np.random.default_rng(wl + 10 * n + bits + 100 * rgb
                                + 1000 * int(lossy))
    peak = (1 << bits) - 1
    y, x = np.mgrid[0:h, 0:w]
    base = peak / 2 + peak / 3 * np.sin(x / 9.0) * np.cos(y / 13.0)
    dtype = np.uint8 if bits == 8 else np.uint16
    planes = [np.clip(base + rng.normal(0, peak / 32, (h, w)) + 7 * c, 0,
                      peak).astype(dtype) for c in range(3 if rgb else 1)]
    codec = ShardedCodec(cfg, [neutral_lut(PARAMS, wl, 2)] * len(planes),
                         PARAMS, ["cpu"] * n)
    padded = [mirror_pad(p, codec.aw, codec.ah) for p in planes]
    comps = dwt_cuda.prep([torch.from_numpy(p) for p in padded], cfg)
    return cfg, planes, padded, codec, [c.numpy() for c in comps]


@pytest.mark.parametrize("case", CASES, ids=_case_id)
def test_shard_mode_forward_rows_match_jax(case):
    """Every shard's band rows at every level (the pieces of the Mallat
    mosaic `ShardedCodec._forward` collects, the gathered levels' too) ==
    the same rows of JAX's `dwt_forward` of the whole plane; the pieces
    cover the mosaic once, and the shards' maxima give its maximum."""
    cfg, planes, _, codec, comps = _setup(case)
    levels, lossy = cfg.wavelet_levels, cfg.is_lossy
    pieces, tops = codec._forward(codec.upload(
        planes if cfg.is_rgb else planes[0]))
    jax_m = np.stack([np.asarray(jdwt.dwt_forward(
        jnp.asarray(c), levels, lossy, cfg.qs)).astype(np.int32)
        for c in comps])
    oracle = np.stack([odwt.dwt_forward(c, levels, lossy, cfg.qs)
                       .astype(np.int32) for c in comps])
    covered = np.zeros(jax_m.shape, int)
    got = np.zeros_like(jax_m)
    for r, c, t in pieces:
        assert t.dtype == torch.int32
        covered[:, r:r + t.shape[-2], c:c + t.shape[-1]] += 1
        got[:, r:r + t.shape[-2], c:c + t.shape[-1]] = t.numpy()
    assert np.all(covered == 1)
    assert max(int(t) for t in tops) == int(np.abs(oracle).max())
    assert np.array_equal(got, oracle)
    if not lossy:
        assert np.array_equal(got, jax_m)
        return
    diff = np.abs(got.astype(np.int64) - jax_m)
    assert diff.max() <= 1
    if cfg.bit_depth == 8:
        assert np.count_nonzero(diff) <= 1e-4 * diff.size


def _psnr(a, b, peak):
    err = a.astype(np.float64) - b.astype(np.float64)
    return 10 * np.log10(peak ** 2 / max(float(np.mean(err * err)), 1e-12))


@pytest.mark.parametrize("case", CASES, ids=_case_id)
def test_shard_mode_reverse_rows_match_jax(case):
    """Every shard's rows of the reconstructed plane (`ShardedCodec.
    _inverse`, each shard reading its neighbours' band rows before a level)
    == the same rows of JAX's `dwt_reverse` of the whole mosaic; with the
    finish, the samples of the whole-plane port (lossless: the input)."""
    cfg, planes, padded, codec, comps = _setup(case)
    levels, lossy = cfg.wavelet_levels, cfg.is_lossy
    mosaic = np.stack([odwt.dwt_forward(c, levels, lossy, cfg.qs)
                       .astype(np.int32) for c in comps])
    whole = [(0, 0, torch.from_numpy(mosaic))]
    rows = codec._inverse(whole, to_samples=False)
    assert [t.shape[-2] for t in rows] == [r1 - r0 for _, r0, r1
                                           in codec._plan[0]]
    got = np.concatenate([t.numpy() for t in rows], axis=-2)
    jax_p = np.stack([np.asarray(jdwt.dwt_reverse(jnp.asarray(m), levels,
                                                  lossy, cfg.qs))
                      for m in mosaic])
    oracle = np.stack([odwt.dwt_reverse(m, levels, lossy, cfg.qs)
                       for m in mosaic])
    assert got.dtype == (np.float32 if lossy else np.int32)
    assert np.array_equal(got, oracle)
    samples = np.concatenate([t.numpy() for t in codec._inverse(whole)],
                             axis=-2)
    want = torch.stack(dwt_cuda.finish(
        [torch.from_numpy(p) for p in oracle], cfg)).numpy()
    assert np.array_equal(samples, want)
    if not lossy:
        assert np.array_equal(got, jax_p)
        assert np.array_equal(samples, np.stack(padded))
        return
    jax_s = torch.stack(dwt_cuda.finish(
        [torch.from_numpy(p) for p in jax_p], cfg)).numpy()
    peak = float((1 << cfg.bit_depth) - 1)
    ref = np.stack(padded)
    assert _psnr(jax_s, ref, peak) >= _psnr(samples, ref, peak) - 0.05


def test_shard_mode_entry_checks():
    """The shard mode's wrapper raises on what the kernels do not take:
    rows outside the buffer or the plane, odd bounds, samples past level
    0, values of the other wavelet, band rows of the wrong type."""
    cfg = CodecConfig(width=W, height=H, wavelet_levels=3)
    x = torch.zeros((72, W), dtype=torch.uint8)
    dwt_cuda.forward_shard([x], cfg, 0, 60, 64, 128)
    with pytest.raises(ValueError, match="even bounds"):
        dwt_cuda.forward_shard([x], cfg, 0, 60, 64, 136)     # past buffer
    with pytest.raises(ValueError, match="even bounds"):
        dwt_cuda.forward_shard([x], cfg, 0, 59, 63, 127)     # odd
    with pytest.raises(ValueError, match="even bounds"):
        dwt_cuda.forward_shard([x], cfg, 0, 200, 200, 256)   # past plane
    with pytest.raises(TypeError, match="values"):
        dwt_cuda.forward_shard([x[:, :W // 2]], cfg, 1, 0, 0, 64)
    with pytest.raises(TypeError, match="int32"):
        dwt_cuda.forward_shard([x.float()], cfg, 0, 60, 64, 128)
    with pytest.raises(ValueError, match="shape"):
        dwt_cuda.forward_shard([x[:, :64]], cfg, 0, 60, 64, 128)
    bands = [torch.zeros((1, 36, W // 2), dtype=torch.int32)] * 4
    dwt_cuda.reverse_shard(bands, cfg, 0, 30, 64, 128)
    with pytest.raises(TypeError, match="int32"):
        dwt_cuda.reverse_shard([b.float() for b in bands], cfg, 0, 30, 64,
                               128)
    with pytest.raises(ValueError, match="even bounds"):
        dwt_cuda.reverse_shard(bands, cfg, 0, 30, 58, 128)
    with pytest.raises(ValueError, match="LL, HL, LH and HH"):
        dwt_cuda.reverse_shard(bands[:3], cfg, 0, 30, 64, 128)


# -- a NumPy model of the shard mode's row mapping (csrc/dwt_forward.cu,
# dwt_reverse.cu with kShard) --------------------------------------------

def _shard_spans(codec, level):
    """The level's (first buffer row, end, r0, r1) of each shard, as
    `ShardedCodec._forward` extends them: HALO rows a side within the
    plane (none after the deep-level gather)."""
    spans = codec._plan[level]
    h = codec.ah >> level
    halo = codec._halo if len(spans) > 1 else 0
    return [(max(r0 - halo, 0), min(r1 + halo, h), r0, r1)
            for _, r0, r1 in spans]


def _model_x2_shard(plane, lossy, in0, in1, r0, r1, log):
    """One X2 shard-mode launch on the buffer rows [in0, in1) of `plane`,
    rows only (the columns are the whole-plane kernel's): tiles from r0,
    each loading its rows with the halo where the buffer has them (else 0),
    16-row register strips with the edge rule on the plane's rows, the
    horizontal pass and the stores of rows < r1 -> the four bands' rows
    [r0 / 2, r1 / 2). `log` gathers the plane rows read, the rows where
    the edge rule fires, and the plane rows stored."""
    h, w = plane.shape
    tile, strip, halo = dwt_cuda.TILE, dwt_cuda.STRIP, dwt_cuda.HALO[lossy]
    size = strip + 2 * halo
    out = [np.zeros(((r1 - r0) // 2, w // 2), plane.dtype) for _ in range(4)]
    for y0 in range(r0, r1, tile):
        gy = np.arange(y0 - halo, y0 + tile + halo)
        keep = (gy >= in0) & (gy < in1)
        idx = gy[keep] - in0                       # the buffer's rows
        assert idx.min() >= 0 and idx.max() < in1 - in0
        log["read"] |= set(gy[keep].tolist())
        a = np.zeros((len(gy), w), plane.dtype)
        a[keep] = plane[in0:in1][idx]
        b = np.zeros((tile, w), plane.dtype)
        for s_ in range(tile // strip):
            g0 = y0 + strip * s_ - halo
            if g0 + halo >= r1:
                continue
            if g0 <= 0 or g0 + size >= h:       # the edge variant
                for i in range(size):
                    g = g0 + i
                    if 0 <= g < h and ((i % 2 and i >= h - 1 - g0)
                                       or (i % 2 == 0 and i <= -g0)):
                        log["edge"].add(g)
            v = _lift_strips(a[strip * s_:strip * s_ + size].T.copy(),
                             np.array(g0), h, _x2_steps(lossy, True))
            b[strip * s_:strip * (s_ + 1)] = v[:, halo:halo + strip].T
        n = min(tile, r1 - y0)
        log["stored"] += list(range(y0, y0 + n))
        bands = dwt.lift_horizontal(torch.from_numpy(b[0:n:2].copy()),
                                    torch.from_numpy(b[1:n:2].copy()), lossy)
        y = (y0 - r0) // 2
        for o, t in zip(out, bands):
            o[y:y + n // 2] = t.numpy()
    return out


def _model_x4_shard(bands, lossy, in0, in1, r0, r1, h, log):
    """One X4 shard-mode launch on band rows [in0, in1) (every band's, the
    whole band's width) -> the plane rows [r0, r1): tiles from r0, each
    loading its tile's band rows with the halo where the buffer has them
    (else 0), the horizontal synthesis of every row, 16-row register
    strips of the vertical synthesis with the edge rule on the plane's
    rows, the stores of rows < r1. `log` as in `_model_x2_shard`, read in
    band rows."""
    ll, hl, lh, hh = bands
    w = 2 * ll.shape[1]
    tile, strip, halo = dwt_cuda.TILE, dwt_cuda.STRIP, dwt_cuda.HALO[lossy]
    size = strip + 2 * halo
    out = np.zeros((r1 - r0, w), ll.dtype)
    for y0 in range(r0, r1, tile):
        gy = np.arange(y0 - halo, y0 + tile + halo)    # the tile's rows
        yb = gy // 2
        keep = (yb >= in0) & (yb < in1)
        idx = yb[keep] - in0
        assert idx.min() >= 0 and idx.max() < in1 - in0
        log["read"] |= set(yb[keep].tolist())
        lo = np.zeros((len(gy), w // 2), ll.dtype)
        hi = np.zeros_like(lo)
        even = keep & (gy % 2 == 0)
        odd = keep & (gy % 2 == 1)
        lo[even], hi[even] = ll[yb[even] - in0], hl[yb[even] - in0]
        lo[odd], hi[odd] = lh[yb[odd] - in0], hh[yb[odd] - in0]
        inv_h = dwt._inv97_h if lossy else dwt._inv53_h
        b = inv_h(torch.from_numpy(lo), torch.from_numpy(hi)).numpy()
        for s_ in range(tile // strip):
            g0 = y0 + strip * s_ - halo
            if g0 + halo >= r1:
                continue
            if g0 <= 0 or g0 + size >= h:
                for i in range(size):
                    g = g0 + i
                    if 0 <= g < h and ((i % 2 and i >= h - 1 - g0)
                                       or (i % 2 == 0 and i <= -g0)):
                        log["edge"].add(g)
            v = _lift_strips(b[strip * s_:strip * s_ + size].T.copy(),
                             np.array(g0), h, _x4_steps(lossy, True))
            n = min(strip, r1 - (y0 + strip * s_))
            if n > 0:
                out[y0 + strip * s_ - r0:y0 + strip * s_ - r0 + n] = \
                    v[:, halo:halo + n].T
        log["stored"] += list(range(y0, min(y0 + tile, r1)))
    return out


def _model_plane(h, w, lossy, seed):
    rng = np.random.default_rng(seed)
    if lossy:
        return (rng.normal(0, 60, (h, w))
                * 2.0 ** rng.integers(-4, 5, (h, w))).astype(np.float32)
    return rng.integers(-40000, 40000, (h, w)).astype(np.int32)


@pytest.mark.parametrize("w,h,wl,n", [
    (1920, 1080, 5, 4),         # uneven: 320/256/256/256, deep levels of
                                # 20 and 16 rows, fewer than a tile
    (2048, 2048, 5, 2),         # level 4: 64 rows a shard
    (512, 256, 6, 4),           # gathered from level 5
    (256, 256, 5, 4),           # 9/7: gathered from level 4
])
@pytest.mark.parametrize("lossy", [False, True])
def test_shard_row_mapping_model(w, h, wl, n, lossy):
    """At every level of the plan, each shard's launch (the model) reads
    no row outside its buffer, fires the edge rule at no plane row but the
    first and the last (at the first and last in the shards that hold
    them; a shard of a few rows may reach the other edge with halo
    positions, whose values it does not store), stores each of its
    interior rows once and nothing else, and gives the rows of the
    whole-plane lifting of transform/dwt.py, both ways."""
    cfg = CodecConfig(width=w, height=h, wavelet_levels=wl, is_lossy=lossy)
    codec = ShardedCodec(cfg, [neutral_lut(PARAMS, wl, 2)], PARAMS,
                         ["cpu"] * n)
    cur = _model_plane(codec.ah, 64, lossy, w + wl + n)
    for level in range(wl):
        lh_ = cur.shape[0]
        want = [t.numpy() for t in dwt.lift_horizontal(
            *dwt.lift_vertical(torch.from_numpy(cur), lossy), lossy)]
        back_want = dwt.unlift_vertical(*dwt.unlift_horizontal(
            *(torch.from_numpy(w_) for w_ in want), lossy), lossy).numpy()
        for in0, in1, r0, r1 in _shard_spans(codec, level):
            log = {"read": set(), "edge": set(), "stored": []}
            got = _model_x2_shard(cur, lossy, in0, in1, r0, r1, log)
            assert log["read"] <= set(range(in0, in1))
            edges = {0} if r0 == 0 else set()
            edges |= {lh_ - 1} if r1 == lh_ else set()
            assert edges <= log["edge"] <= {0, lh_ - 1}
            assert sorted(log["stored"]) == list(range(r0, r1))
            for g, w_ in zip(got, want):
                assert np.array_equal(g, w_[r0 // 2:r1 // 2]), level
            # X4 on the band rows `ShardedCodec._inverse` gives it: HALO /
            # 2 a side, clipped at the band
            k = dwt_cuda.HALO[lossy] // 2
            b0, b1 = max(r0 // 2 - k, 0), min(r1 // 2 + k, lh_ // 2)
            log = {"read": set(), "edge": set(), "stored": []}
            back = _model_x4_shard([w_[b0:b1] for w_ in want], lossy, b0,
                                   b1, r0, r1, lh_, log)
            assert log["read"] <= set(range(b0, b1))
            assert edges <= log["edge"] <= {0, lh_ - 1}
            assert sorted(log["stored"]) == list(range(r0, r1))
            assert np.array_equal(back, back_want[r0:r1]), level
        cur = np.ascontiguousarray(want[0])
