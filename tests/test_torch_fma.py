"""`dwt_cuda.fma_row`, the port's float32 colour transform, against the
exactly fused chain fma(m2, c, fma(m1, b, m0 * a)): each fma rounded once
to nearest-even float32, computed here with exact rationals
(`fractions.Fraction`). Tolerance 0.

The chain is the NumPy oracle's ICT (an FMA-contracting float32
`tensordot`) and the X2/X4 kernels' `__fmaf_rn` chain, so the plain
version, the kernels and the oracle agree by construction. A float64 add
followed by a cast to float32 rounds twice; the constructed case below is
one where that differs from the fused result.
"""

from fractions import Fraction

import numpy as np
import pytest
import torch

from picsong_tpu.reference import codec as oracle
from picsong_tpu_torch.core import spec
from picsong_tpu_torch.transform.dwt_cuda import fma_row
from test_torch_rgb_depth import _blas_contracts_ict


def round_f32(x: Fraction) -> np.float32:
    """The float32 nearest to x, ties to even (no overflow)."""
    if x == 0:
        return np.float32(0.0)
    sign, x = (-1 if x < 0 else 1), abs(x)
    e = x.numerator.bit_length() - x.denominator.bit_length()
    if Fraction(2) ** e > x:
        e -= 1
    ulp = Fraction(2) ** (max(e, -126) - 23)
    q = x / ulp
    n = q.numerator // q.denominator
    rem = q - n
    if rem > Fraction(1, 2) or (rem == Fraction(1, 2) and n % 2):
        n += 1
    return np.float32(float(sign * n * ulp))


def fused(m_row, a, b, c) -> np.ndarray:
    """The exactly fused chain, element by element."""
    m0, m1, m2 = (np.float32(m) for m in m_row)
    out = []
    for x, y, z in zip(a.tolist(), b.tolist(), c.tolist()):
        acc = np.float32(m0 * np.float32(x))
        acc = round_f32(Fraction(float(m1)) * Fraction(y) + Fraction(float(acc)))
        acc = round_f32(Fraction(float(m2)) * Fraction(z) + Fraction(float(acc)))
        out.append(acc)
    return np.array(out, dtype=np.float32)


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.asarray(x, dtype=np.float32))


def test_constructed_double_rounding_case():
    """m1 * b + a lies just below the midpoint between two float32 values,
    and its float64 rounding lands on that midpoint: the old float64 add
    then cast gave 1.0000002 (rounding twice), the fused result is
    1.0000001."""
    one_ulp = np.float32(1 + 2.0 ** -23)
    m_row = (1.0, 2.0 ** -24 * (1 - 2.0 ** -23), 0.0)
    a = b = np.array([one_ulp], dtype=np.float32)
    c = np.zeros(1, dtype=np.float32)
    want = fused(m_row, a, b, c)
    assert want[0] == np.float32(1 + 2.0 ** -23)
    twice = (_t(b).double() * m_row[1] + _t(a).double()).float()
    assert twice.item() == np.float32(1 + 2 * 2.0 ** -23)      # the fault
    got = fma_row(m_row, _t(a), _t(b), _t(c))
    assert got.dtype == torch.float32
    assert np.array_equal(got.numpy(), want)


def _spread(rng, n, lo, hi) -> np.ndarray:
    """float32 values of random sign and mantissa, exponents in [lo, hi]."""
    mant = rng.uniform(1.0, 2.0, n)
    sign = rng.choice([-1.0, 1.0], n)
    return (sign * mant * 2.0 ** rng.integers(lo, hi + 1, n)).astype(
        np.float32)


# m1 * (1 + 2^-23) is 2^-24 (1 - 2^-46): just under half an ulp of a
# float32 in [1, 2), so m1 * b + a sits just off a midpoint, where a
# double rounding breaks the tie the other way for half the mantissas
_NEAR_HALF = 2.0 ** -24 * (1 - 2.0 ** -23)


@pytest.mark.parametrize("matrix", ["forward", "backward", "random",
                                    "midpoints"])
def test_sweep_matches_fused(matrix):
    """The spec's ICT rows (and random rows) on inputs whose exponents span
    2^-24 .. 2^24, with exact ties and cancellation made likely by small
    integer inputs mixed in; and near-midpoint sums in both fma steps, of
    either sign (random inputs almost never reach a double rounding)."""
    rng = np.random.default_rng({"forward": 1, "backward": 2, "random": 3,
                                 "midpoints": 4}[matrix])
    n = 1500
    a, b, c = (_spread(rng, n, -24, 24) for _ in range(3))
    ints = rng.integers(-300, 300, (3, n // 3)).astype(np.float32)
    a[:n // 3], b[:n // 3], c[:n // 3] = ints
    rows = {"forward": spec.ICT_FORWARD, "backward": spec.ICT_BACKWARD,
            "random": _spread(rng, 9, -12, 12).reshape(3, 3),
            "midpoints": [(1.0, _NEAR_HALF, 0.0), (1.0, 0.0, _NEAR_HALF),
                          (1.0, -_NEAR_HALF, 0.0)]}[matrix]
    if matrix == "midpoints":
        a = _spread(rng, n, 0, 0)
        b[:] = c[:] = np.float32(1 + 2.0 ** -23)
    for row in rows:
        got = fma_row(row, _t(a), _t(b), _t(c))
        assert np.array_equal(got.numpy(), fused(row, a, b, c))


def test_oracle_ict_equals_fma_row():
    """The lossy RGB byte gates' premise: the oracle's ICT both ways is
    `fma_row`'s chain (on 8-bit DC-shifted samples forward, and on
    reconstructed float components back, rounded as the finish does)."""
    if not _blas_contracts_ict():
        pytest.skip("NumPy's BLAS evaluates the oracle's float32 ICT "
                    "without FMA, so its bytes are not the FMA chain")
    rng = np.random.default_rng(7)
    r, g, b = rng.integers(-128, 128, (3, 20000)).astype(np.float32)
    for row, want in zip(spec.ICT_FORWARD, oracle.ict_forward(r, g, b)):
        assert np.array_equal(fma_row(row, _t(r), _t(g), _t(b)).numpy(),
                              want)
    y, cb, cr = rng.uniform(-200, 200, (3, 20000)).astype(np.float32)
    for row, want in zip(spec.ICT_BACKWARD, oracle.ict_inverse(y, cb, cr)):
        got = torch.round(fma_row(row, _t(y), _t(cb), _t(cr))
                          + float(np.float32(0.01))).to(torch.int32)
        assert np.array_equal(got.numpy(), want)
