"""Whether the window's outputs are correct: the sampled frames' packed
codestreams and decoded samples against the plain reference's of each
frame's own pool image, exactly.

Two numbers are compared, each with the limit 0, since the configurations
state an exact result (the codestream is the format, lossless decodes to
its input, and the 9/7 path's arithmetic is fixed to the rounding):

- `codestream_diff_shorts`: over the sampled frames and their
  components, the shorts that differ from the reference's codestream
  (header, MSB and size pairs, payload, filler), a short missing or extra
  counted as one;
- `decoded_diff_samples`: the decoded samples that differ from the
  reference's decode, every sample of a plane of the wrong shape counted.
"""

from __future__ import annotations

import numpy as np

LIMITS = {"codestream_diff_shorts": 0, "decoded_diff_samples": 0}


def _diff(a: np.ndarray, b: np.ndarray) -> int:
    n = min(a.size, b.size)
    return int(np.count_nonzero(a.reshape(-1)[:n] != b.reshape(-1)[:n])) \
        + abs(a.size - b.size)


def _frame(codestreams, planes, ref) -> tuple[int, int]:
    shorts = samples = 0
    if len(codestreams) != len(ref.codestreams):
        shorts += sum(c.size for c in ref.codestreams)
    for got, want in zip(codestreams, ref.codestreams):
        shorts += _diff(np.asarray(got).view(np.uint16), want)
    if len(planes) != len(ref.decoded):
        samples += sum(p.size for p in ref.decoded)
    for got, want in zip(planes, ref.decoded):
        got = np.asarray(got)
        samples += (_diff(got.astype(want.dtype), want)
                    if got.shape == want.shape else want.size)
    return shorts, samples


def compare(kept: list[tuple], expected: list) -> tuple[dict[str, int], int]:
    """`kept`: (request, image, (codestreams, planes)) a sampled frame, on
    the host; `expected`: the reference's `Coded` of each pool image.
    Returns the numbers compared, summed over the frames, and the count of
    requests with a sampled frame that differs."""
    diffs = [_frame(*out, expected[image]) for _, image, out in kept]
    return ({"codestream_diff_shorts": sum(d[0] for d in diffs),
             "decoded_diff_samples": sum(d[1] for d in diffs)},
            len({r for (r, _, _), d in zip(kept, diffs) if any(d)}))


def verdict(numbers: dict[str, int]) -> bool:
    return all(numbers[k] <= limit for k, limit in LIMITS.items())
