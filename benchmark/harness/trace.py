"""The device trace of a `--trace 1` run, read into plain lists.

`torch.profiler` records the window: the card's kernel, memcpy and memset
spans, and on the host the `record_function` labels (the benchmark's own
`bench/...` around its calls, and the program's stage labels inside
`TorchCodec`). The arithmetic is the port's `obs/trace.py`, copied: a
device span is an event on the CUDA timeline that is not a label (a
label's span there runs from its first to its last device op, idle gaps
included), and the busy time is the union of the spans. The profiler has
dropped kernel spans on the card before, so a kernel's time is read as the
mean of its spans seen times the launches the program counted (see
`readers.py`).
"""

from __future__ import annotations

import re
from collections import defaultdict
from dataclasses import dataclass, field


@dataclass
class Trace:
    spans: list[tuple[str, int, int]]      # device: (name, start, end) ns
    labels: list[tuple[str, int, int]]     # host labels, ns
    window: tuple[int, int]                # the traced window, ns
    requests: list[tuple[tuple[int, int], tuple[int, int]]] = field(
        default_factory=list)               # (encode, decode) spans, ns


def read(prof) -> Trace:
    """The spans and labels of a finished profile."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    spans, labels = [], []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == cuda:
            if not e.is_user_annotation():
                spans.append((e.name(), e.start_ns(), e.end_ns()))
        elif e.is_user_annotation():
            labels.append((e.name(), e.start_ns(), e.end_ns()))
    labels.sort(key=lambda x: x[1])
    windows = [(s, e) for n, s, e in labels if n == "bench/window"]
    window = windows[0] if windows else (0, 0)
    enc = [(s, e) for n, s, e in labels if n == "bench/encode"]
    dec = [(s, e) for n, s, e in labels if n == "bench/decode"]
    inside = [(n, max(s, window[0]), min(e, window[1]))
              for n, s, e in spans if e > window[0] and s < window[1]]
    return Trace(inside, labels, window, list(zip(enc, dec)))


def merged(intervals) -> list[tuple[int, int]]:
    out: list[list[int]] = []
    for lo, hi in sorted(intervals):
        if out and lo <= out[-1][1]:
            out[-1][1] = max(out[-1][1], hi)
        else:
            out.append([lo, hi])
    return [(lo, hi) for lo, hi in out]


def union_ns(intervals) -> int:
    """Total length of the union of (start, end) intervals."""
    return sum(hi - lo for lo, hi in merged(intervals))


def short_name(name: str) -> str:
    """A kernel's name without its namespaces, return type and
    parameters: `bpc_encode_kernel<2, false>`."""
    s = name.replace("(anonymous namespace)::", "")
    s = re.sub(r"^void ", "", s)
    depth, cut = 0, len(s)
    for i, ch in enumerate(s):
        if ch == "<":
            depth += 1
        elif ch == ">":
            depth -= 1
        elif ch == "(" and depth == 0:
            cut = i
            break
    s = s[:cut]
    head, sep, tail = s.partition("<")
    return (head.rsplit("::", 1)[-1] + sep + tail)[:100]


def _innermost(labels, points):
    """The innermost host label around each of the sorted `points`."""
    out, stack, j = [], [], 0
    for t in points:
        while j < len(labels) and labels[j][1] <= t:
            while stack and stack[-1][2] < labels[j][1]:
                stack.pop()
            stack.append(labels[j])
            j += 1
        while stack and stack[-1][2] < t:
            stack.pop()
        out.append(stack[-1][0] if stack else "(no label)")
    return out


def breakdown(trace: Trace, top: int = 10) -> dict:
    """The device operations that took most time, and the idle time of the
    window by the host label around each gap, in seconds."""
    ops = defaultdict(int)
    for name, s, e in trace.spans:
        ops[short_name(name)] += e - s
    busy = merged((s, e) for _, s, e in trace.spans)
    lo, hi = trace.window
    edges = [lo] + [x for iv in busy for x in iv] + [hi]
    gaps = [(edges[k], edges[k + 1]) for k in range(0, len(edges), 2)
            if edges[k + 1] > edges[k]]
    idle = defaultdict(int)
    mids = [(s + e) // 2 for s, e in gaps]
    for (s, e), label in zip(gaps, _innermost(trace.labels, mids)):
        idle[label] += e - s
    return {"device_ops": [[k, v / 1e9] for k, v in sorted(
                ops.items(), key=lambda kv: -kv[1])[:top]],
            "idle_gaps": [[k, v / 1e9] for k, v in sorted(
                idle.items(), key=lambda kv: -kv[1])[:top]]}
