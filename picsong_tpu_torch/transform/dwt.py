"""Lifting DWT, CDF 5/3 (int32) and 9/7 (float32), as torch ops, Mallat
layout.

Counterpart of `picsong_tpu.transform.dwt`: full-plane lifting with
symmetric boundary extension, vertical pass then horizontal on the way
forward, horizontal then vertical on the way back.

5/3: torch's `>>` on int32 is an arithmetic shift, which is the
reference's rounding (DWTGenerator.cu:70-85), so the output is
bit-identical to the NumPy oracle and to the JAX package.

9/7: float32 in the JAX op order, one rounding per torch op, with the
products of constants (gain * qs) formed in numpy float32. Each torch op
is its own kernel on a card, so nothing is contracted into an FMA, and the
quantized coefficients equal the NumPy oracle's (`reference/dwt.py`).
Division by a constant goes through a 0-dim tensor on the operand's
device: PyTorch's CUDA true division by a CPU scalar multiplies by the
reciprocal, which can differ by one ulp from the division the CPU and the
oracle do.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core import spec

_ALPHA, _BETA, _GAMMA, _DELTA = (float(c) for c in (
    spec.I97_ALPHA, spec.I97_BETA, spec.I97_GAMMA, spec.I97_DELTA))
_K1, _K2 = float(spec.I97_K1), float(spec.I97_K2)


def _div(x: torch.Tensor, c) -> torch.Tensor:
    """x / c, rounded once, on any device (see the module docstring). The
    divisor is filled on the device, not copied from the host, so that no
    copy synchronises the stream."""
    return x / torch.full((), float(c), dtype=torch.float32, device=x.device)


# Vertical pass: rows are axis 0.

def _split(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    h = x.shape[0]
    pairs = x.reshape(h // 2, 2, *x.shape[1:])
    return pairs[:, 0], pairs[:, 1]


def _merge(even: torch.Tensor, odd: torch.Tensor) -> torch.Tensor:
    out = torch.stack([even, odd], dim=1)
    return out.reshape(even.shape[0] * 2, *even.shape[1:])


def _nxt(a: torch.Tensor) -> torch.Tensor:
    return torch.cat([a[1:], a[-1:]], dim=0)


def _prv(a: torch.Tensor) -> torch.Tensor:
    return torch.cat([a[:1], a[:-1]], dim=0)


def _fwd53(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    even, odd = _split(x)
    d = odd - ((even + _nxt(even)) >> 1)
    s = even + ((_prv(d) + d + 2) >> 2)
    return s, d


def _inv53(s: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    even = s - ((_prv(d) + d + 2) >> 2)
    odd = d + ((even + _nxt(even)) >> 1)
    return _merge(even, odd)


def _fwd97(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    even, odd = _split(x)
    odd = odd + (even + _nxt(even)) * _ALPHA
    even = even + (_prv(odd) + odd) * _BETA
    odd = odd + (even + _nxt(even)) * _GAMMA
    even = (even + (_prv(odd) + odd) * _DELTA) * _K2
    odd = odd * _K1
    return even, odd


def _inv97(s: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    odd = _div(d, _K1)
    even = _div(s, _K2) - (_prv(odd) + odd) * _DELTA
    odd = odd - (even + _nxt(even)) * _GAMMA
    even = even - (_prv(odd) + odd) * _BETA
    odd = odd - (even + _nxt(even)) * _ALPHA
    return _merge(even, odd)


# Horizontal pass: columns are axis 1.

def _split_l(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    h, w = x.shape
    pairs = x.reshape(h, w // 2, 2)
    return pairs[..., 0], pairs[..., 1]


def _merge_l(even: torch.Tensor, odd: torch.Tensor) -> torch.Tensor:
    out = torch.stack([even, odd], dim=2)
    return out.reshape(even.shape[0], even.shape[1] * 2)


def _nxt_l(a: torch.Tensor) -> torch.Tensor:
    return torch.cat([a[:, 1:], a[:, -1:]], dim=1)


def _prv_l(a: torch.Tensor) -> torch.Tensor:
    return torch.cat([a[:, :1], a[:, :-1]], dim=1)


def _fwd53_h(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    even, odd = _split_l(x)
    d = odd - ((even + _nxt_l(even)) >> 1)
    s = even + ((_prv_l(d) + d + 2) >> 2)
    return s, d


def _inv53_h(s: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    even = s - ((_prv_l(d) + d + 2) >> 2)
    odd = d + ((even + _nxt_l(even)) >> 1)
    return _merge_l(even, odd)


def _fwd97_h(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    even, odd = _split_l(x)
    odd = odd + (even + _nxt_l(even)) * _ALPHA
    even = even + (_prv_l(odd) + odd) * _BETA
    odd = odd + (even + _nxt_l(even)) * _GAMMA
    even = (even + (_prv_l(odd) + odd) * _DELTA) * _K2
    odd = odd * _K1
    return even, odd


def _inv97_h(s: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    odd = _div(d, _K1)
    even = _div(s, _K2) - (_prv_l(odd) + odd) * _DELTA
    odd = odd - (even + _nxt_l(even)) * _GAMMA
    even = even - (_prv_l(odd) + odd) * _BETA
    odd = odd - (even + _nxt_l(even)) * _ALPHA
    return _merge_l(even, odd)


def _fwd_level(plane: torch.Tensor, lossy: bool):
    fwd_v, fwd_h = (_fwd97, _fwd97_h) if lossy else (_fwd53, _fwd53_h)
    lo_v, hi_v = fwd_v(plane)                     # vertical first
    ll, hl = fwd_h(lo_v)                          # then horizontal
    lh, hh = fwd_h(hi_v)
    return ll, hl, lh, hh


def _inv_level(ll, hl, lh, hh, lossy: bool) -> torch.Tensor:
    inv_v, inv_h = (_inv97, _inv97_h) if lossy else (_inv53, _inv53_h)
    lo_v = inv_h(ll, hl)                          # horizontal inverse first
    hi_v = inv_h(lh, hh)
    return inv_v(lo_v, hi_v)


def _check(shape, levels: int) -> None:
    h, w = shape
    if levels < 1 or h % (1 << levels) or w % (1 << levels):
        raise ValueError(
            f"{levels} wavelet levels need a plane whose sides are multiples "
            f"of {1 << max(levels, 0)}; got {h}x{w}")


def dwt_forward(plane: torch.Tensor, levels: int, lossy: bool = False,
                qs: float = 1.0) -> torch.Tensor:
    """Forward multi-level DWT into the Mallat mosaic.

    Lossless: int32 (H, W) -> int32. Lossy: float32 -> float32, each
    subband scaled by its gain * qs (the final LL too, the intermediate LL
    not; writeSubbands, DWTGenerator.cu:403-433); truncate to int32 before
    entropy coding."""
    _check(plane.shape, levels)
    if lossy and plane.dtype != torch.float32:
        raise TypeError(f"the 9/7 DWT takes a float32 plane, got {plane.dtype}")
    cur = plane if lossy else plane.to(torch.int32)
    qs32 = np.float32(qs)
    quads = []
    for level in range(levels):
        ll, hl, lh, hh = _fwd_level(cur, lossy)
        if lossy:
            g = spec.WAVELET_QSTEPS[level]
            hl = hl * float(g[spec.QS_HL] * qs32)
            lh = lh * float(g[spec.QS_LH] * qs32)
            hh = hh * float(g[spec.QS_HH] * qs32)
            if level == levels - 1:
                ll = ll * float(g[spec.QS_LL] * qs32)
        quads.append((hl, lh, hh))
        cur = ll
    out = cur
    for hl, lh, hh in reversed(quads):
        out = torch.cat([torch.cat([out, hl], dim=1),
                         torch.cat([lh, hh], dim=1)], dim=0)
    return out


def _dequant(q: torch.Tensor, gain, qs32) -> torch.Tensor:
    """Midpoint dequantization, (|q| + 0.5) * sign / gain / qs for q != 0
    (readSubbandsLossy, DWTGenerator.cu:513-542)."""
    q = q.to(torch.int32)
    mag = q.abs().to(torch.float32) + float(spec.RECONSTRUCTION_FACTOR)
    val = _div(_div(torch.where(q < 0, -mag, mag), gain), qs32)
    return torch.where(q == 0, torch.zeros_like(val), val)


def dwt_reverse(mallat: torch.Tensor, levels: int, lossy: bool = False,
                qs: float = 1.0) -> torch.Tensor:
    """Inverse multi-level DWT from an integer Mallat mosaic: int32 out
    (5/3), or float32 out after midpoint dequantization (9/7)."""
    _check(mallat.shape, levels)
    mallat = mallat.to(torch.int32)
    h, w = mallat.shape
    qs32 = np.float32(qs)
    ll = None
    for level in range(levels - 1, -1, -1):
        hh_, wh_ = h >> (level + 1), w >> (level + 1)
        hl = mallat[:hh_, wh_:2 * wh_]
        lh = mallat[hh_:2 * hh_, :wh_]
        hh = mallat[hh_:2 * hh_, wh_:2 * wh_]
        if lossy:
            g = spec.WAVELET_QSTEPS[level]
            hl = _dequant(hl, g[spec.QS_HL], qs32)
            lh = _dequant(lh, g[spec.QS_LH], qs32)
            hh = _dequant(hh, g[spec.QS_HH], qs32)
            if level == levels - 1:
                ll = _dequant(mallat[:hh_, :wh_], g[spec.QS_LL], qs32)
        elif ll is None:
            ll = mallat[:hh_, :wh_]
        ll = _inv_level(ll, hl, lh, hh, lossy)
    return ll
