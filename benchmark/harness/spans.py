"""The program's own spans in the trace of a `--trace 1` run: the card's
idle time a request split by the program layer the host was in, each
kernel wrapper's host time a call, and the program's read-backs a request.

The port (`picsong_tpu_torch/obs/trace.py`) opens a profiler label under
`picsong/` at each layer boundary of its main path. They nest inside the
benchmark's `bench/...` labels. A span's layer is the wrapper its name
starts with: `x2`, `k1`, `x3.pack`, `x3.unpack`, `k2`, `x4`, a read-back
under the wrapper it serves (`x2.read_max` under `x2`,
`x3.pack.read_total` under `x3.pack`); any other `picsong/` span is the
codec's own (`encode_planes`, `decode_planes`, `encode`, `decode` and
their children).

The profiler puts the card's spans on the host's clock, and that
alignment drifts within a run, by up to milliseconds: kernels then sit
before the wrapper call that launched them. So the card's spans are first
re-anchored (`anchored`). Each wrapper's n-th kernel span belongs to its
call n // L, L its launches a call (a kernel whose spans are not L a call,
one dropped, is left out of this). Each half request (the benchmark's
`bench/encode` or `bench/decode`, which ends in a synchronisation) bounds
the card clock's offset: every kernel starts after its wrapper call
starts and ends before the half ends. One offset meets all the bounds
of a stretch of 2 * REACH + 1 halves around a half, or else of REACH + 1
up to it or from it, unless it moved within; the half's own bounds are
used then. An offset of 0 is kept
wherever the bounds allow it. Elsewhere the offset puts the stretch's
earliest kernel as far after its wrapper's start as the stretches read
at offset 0 put theirs (the median), within the bounds. Every card span
moves by its half's offset: a paired kernel's, its wrapper call's half;
any other span's, the half its start falls in (halves split at the middle
of the gap between their paired kernels).

The window's idle time (the window less the union of the card's spans, as
`device_idle_pct` reads it, from the re-anchored spans) is cut at every
program span's start and end, and each piece goes to the layer of the
innermost program span over it (the one opened last), or to `outside`
where none is: the layers and `outside` add up to the idle time exactly.
A wrapper's host time is its span less its read-back children.

A program without these spans or without the `READBACKS` counter gives
nothing: each reader returns None, as it does on a trace with no device
span (a run on the CPU).
"""

from __future__ import annotations

import ast
import bisect
import functools
import json
import math
import re
import statistics
from pathlib import Path

from .trace import Trace, merged

PREFIX = "picsong/"
# a metric's layer name: the wrapper span's name under PREFIX
WRAPPERS = {"x2": "x2", "k1": "k1", "x3_pack": "x3.pack",
            "x3_unpack": "x3.unpack", "k2": "k2", "x4": "x4"}
CODEC = "codec"
OUTSIDE = "outside"
NOTE = "program spans: "
METRICS = Path(__file__).resolve().parents[1] / "metrics"
# halves on each side of a half whose bounds its stretch's offset meets
REACH = 16


@functools.cache
def kernel_pattern(key: str) -> str:
    """The pattern `metrics/<key>_roofline.py` matches the kernel's spans
    by: the last argument of its `roofline_pct` call."""
    tree = ast.parse((METRICS / f"{key}_roofline.py").read_text())
    (call,) = [node for node in ast.walk(tree)
               if isinstance(node, ast.Call)
               and getattr(node.func, "id", None) == "roofline_pct"]
    return ast.literal_eval(call.args[-1])


def layer_of(name: str) -> str | None:
    """The layer of a label: a key of WRAPPERS, CODEC, or None for a label
    that is not the program's."""
    if not name.startswith(PREFIX):
        return None
    rest = name[len(PREFIX):]
    for key, wrapper in WRAPPERS.items():
        if rest == wrapper or rest.startswith(wrapper + "."):
            return key
    return CODEC


def _program(trace) -> list[tuple[int, int, str, str]]:
    """(start, end, name, layer) of the program's spans in the window."""
    lo, hi = trace.window
    return [(s, e, name, layer) for name, s, e in trace.labels
            if (layer := layer_of(name)) and s >= lo and e <= hi]


def _pairs(trace) -> tuple[list, list[tuple[int, int, int, int, int, int]],
                           list]:
    """The half requests, and (half, wrapper call's start, half's end,
    kernel's start, kernel's end, its index in `trace.spans`) of every
    kernel span paired with its call; the kernels left unpaired."""
    halves = sorted(h for request in trace.requests for h in request)
    starts = [s for s, _ in halves]
    labels = _program(trace)
    pairs, unpaired = [], []
    for key, wrapper in WRAPPERS.items():
        calls = sorted(s for s, _, name, _ in labels
                       if name == PREFIX + wrapper)
        pattern = re.compile(kernel_pattern(key))
        kernels = sorted((s, e, i) for i, (name, s, e)
                         in enumerate(trace.spans) if pattern.search(name))
        if not calls:
            continue
        per_call, rest = divmod(len(kernels), len(calls))
        if rest or not per_call:
            unpaired.append(key)
            continue
        for n, (s, e, i) in enumerate(kernels):
            call = calls[n // per_call]
            h = bisect.bisect_right(starts, call) - 1
            if h >= 0 and call < halves[h][1]:
                pairs.append((h, call, halves[h][1], s, e, i))
    return halves, pairs, unpaired


def anchored(trace) -> tuple[Trace, dict]:
    """The trace with its card spans re-anchored to the host's labels,
    and what the re-anchoring read: the paired kernel spans, how many
    started after their wrapper call's start as recorded and how many lie
    between it and their half's end once moved; the halves bounded, those
    moved, the offsets (us), the lead kept (us), the median width of the
    moved halves' bounds (us: the offset's uncertainty there), the halves
    whose own bounds disagree (moved to their middle), and the kernels
    left unpaired."""
    halves, pairs, unpaired = _pairs(trace)
    lo = [-math.inf] * len(halves)
    hi = [math.inf] * len(halves)
    first = [math.inf] * len(halves)
    last = [-math.inf] * len(halves)
    for h, call, end, s, e, _ in pairs:
        lo[h] = max(lo[h], call - s)
        hi[h] = min(hi[h], end - e)
        first[h] = min(first[h], s)
        last[h] = max(last[h], e)
    used = [h for h in range(len(halves)) if first[h] < math.inf]
    bounds = []
    for k, h in enumerate(used):
        a, b = lo[h], hi[h]
        for near in (used[max(0, k - REACH):k + REACH + 1],
                     used[max(0, k - REACH):k + 1], used[k:k + REACH + 1]):
            wide = (max(lo[j] for j in near), min(hi[j] for j in near))
            if wide[0] <= wide[1]:
                a, b = wide
                break
        bounds.append((a, b))
    leads = [-a for a, b in bounds if a <= 0 <= b]
    lead = round(statistics.median(leads)) if leads else 0
    offset, widths, disagree = {}, [], 0
    for h, (a, b) in zip(used, bounds):
        if a > b:
            disagree += 1
            offset[h] = (a + b) // 2
        elif a <= 0 <= b:
            offset[h] = 0
        else:
            offset[h] = min(a + lead, b)
            widths.append(b - a)
    cuts = [(last[p] + first[h]) / 2 for p, h in zip(used, used[1:])]
    shifts = [offset[h] for h in used]
    paired = {i: offset[h] for h, *_, i in pairs}
    w0, w1 = trace.window
    spans = []
    for i, (name, s, e) in enumerate(trace.spans):
        d = paired.get(i, shifts[bisect.bisect_right(cuts, s)]
                       if shifts else 0)
        if e + d > w0 and s + d < w1:
            spans.append((name, max(w0, s + d), min(w1, e + d)))
    moved = [d for d in shifts if d]
    stats = {
        "kernel_spans": len(pairs),
        "after_their_wrapper": sum(s >= call
                                   for _, call, _, s, _, _ in pairs),
        "anchored": sum(call - s <= offset[h] <= end - e
                        for h, call, end, s, e, _ in pairs),
        "halves": len(used), "moved": len(moved),
        "offset_us": [min(shifts, default=0) / 1e3,
                      max(shifts, default=0) / 1e3],
        "lead_us": lead / 1e3,
        "bound_us": statistics.median(widths) / 1e3 if widths else 0.0,
        "disagree": disagree, "unpaired": unpaired}
    return Trace(spans, trace.labels, trace.window, trace.requests), stats


def _pieces(spans, lo: int, hi: int) -> list[tuple[int, int, str]]:
    """[lo, hi) cut at every span's start and end: (start, end, layer of
    the innermost span open over it, or OUTSIDE)."""
    events = []
    for k, (s, e, _, _) in enumerate(spans):
        # at one instant: ends before starts; the outer span opens first
        # and closes last
        events.append((s, 1, -e, k))
        events.append((e, 0, -s, k))
    events.sort()
    pieces, open_, t = [], [], lo
    for when, starts, _, k in events:
        if when > t:
            pieces.append((t, when, spans[open_[-1]][3] if open_
                           else OUTSIDE))
            t = when
        if starts:
            open_.append(k)
        elif open_[-1] == k:
            open_.pop()
        else:
            open_.remove(k)
    if hi > t:
        pieces.append((t, hi, OUTSIDE))
    return pieces


def idle_split(trace) -> dict[str, int]:
    """The window's idle ns by layer (every key of WRAPPERS, CODEC and
    OUTSIDE), from the trace's card spans as they stand."""
    lo, hi = trace.window
    busy = merged((s, e) for _, s, e in trace.spans)
    edges = [lo] + [x for iv in busy for x in iv] + [hi]
    gaps = [(edges[k], edges[k + 1]) for k in range(0, len(edges), 2)
            if edges[k + 1] > edges[k]]
    idle = dict.fromkeys([*WRAPPERS, CODEC, OUTSIDE], 0)
    j = 0
    for s, e, layer in _pieces(_program(trace), lo, hi):
        while j < len(gaps) and gaps[j][1] <= s:
            j += 1
        k = j
        while k < len(gaps) and gaps[k][0] < e:
            idle[layer] += min(e, gaps[k][1]) - max(s, gaps[k][0])
            k += 1
    return idle


def _requests(run) -> int:
    return len(run.trace.requests)


def _idle_ms(trace) -> float:
    lo, hi = trace.window
    busy = sum(e - s for s, e in merged((s, e) for _, s, e in trace.spans))
    return (hi - lo - busy) / 1e6


def _split(run) -> dict[str, int] | None:
    """The idle split of the run's re-anchored trace, computed once a run;
    None without device spans, requests or program spans. Its first
    reading adds a note: the split a request with `outside`, the device's
    idle a request before and after the re-anchoring, and what the
    re-anchoring read."""
    if not hasattr(run, "_idle_split"):
        split = None
        if run.trace.spans and _requests(run) and _program(run.trace):
            moved, stats = anchored(run.trace)
            split = idle_split(moved)
            n = _requests(run)
            run.notes.append(NOTE + json.dumps({
                "requests": n,
                "idle_ms": {k: v / n / 1e6 for k, v in split.items()},
                "device_idle_ms": _idle_ms(run.trace) / n,
                "anchored_idle_ms": _idle_ms(moved) / n, **stats}))
        run._idle_split = split
    return run._idle_split


def idle_ms(run, layer: str) -> float | None:
    """The card's idle ms a request while the host was in `layer`."""
    split = _split(run)
    return None if split is None else split[layer] / _requests(run) / 1e6


def host_us(run, key: str) -> float | None:
    """The mean host us a call of wrapper `key`: its span less its
    read-back children's."""
    if not run.trace.spans:
        return None
    name = PREFIX + WRAPPERS[key]
    spans = _program(run.trace)
    calls = [(s, e) for s, e, n, _ in spans if n == name]
    if not calls:
        return None
    reads = sorted((s, e) for s, e, n, _ in spans
                   if n.startswith(name + "."))
    starts = [s for s, _ in reads]
    total = 0
    for s, e in calls:
        k = bisect.bisect_left(starts, s)
        while k < len(reads) and reads[k][0] < e:
            if reads[k][1] <= e:
                total -= reads[k][1] - reads[k][0]
            k += 1
        total += e - s
    return total / len(calls) / 1e3


def readbacks(run) -> float | None:
    """The program's blocking reads of a device value a request (its
    `READBACKS`, counted around the window; NaN from a program without
    the counter, `counters/readbacks.py`)."""
    count = run.launches.get("readbacks", math.nan)
    if not run.trace.spans or not _requests(run) or math.isnan(count):
        return None
    return count / _requests(run)
