"""What the per-layer readers share: the run they read, and the time of a
kernel and its share of the roofline.

A request in the trace codes the mix's `frames_per_request` pool images
(`images.of_request`): a roofline sums the reference's work over every
frame, while the readers that report "a request" stay per request.

A kernel's time in the window is the mean of its spans seen, matched by
name, times the launches the program counted: the profiler can drop a
span, never a launch. A kernel launches once or more a counted call (X2
and X4 once a level); that count is the spans seen a call, rounded. A
traced run that counted launches of a kernel and saw none of its spans
fails, rather than print a share.
"""

from __future__ import annotations

import bisect
import importlib
import re
from dataclasses import dataclass, field

from .images import of_request
from .trace import Trace, union_ns


class MissingSpans(RuntimeError):
    """The program counted launches of a kernel the trace never saw."""


@dataclass
class Run:
    trace: Trace
    launches: dict[str, int]     # counted in the window, by kernel
    expected: list               # the reference's `Coded` a pool image
    cfg: object                  # the reference's `Config`
    n_images: int
    frames: int = 1              # pool images a request codes
    notes: list[str] = field(default_factory=list)

    def images(self) -> list[int]:
        """The pool image of every frame of every request in the trace."""
        return [image for i in range(len(self.trace.requests))
                for image in of_request(i, self.frames, self.n_images)]


def kernel_ns(run: Run, kernel: str, pattern: str) -> float | None:
    calls = run.launches.get(kernel, 0)
    if not calls:
        return None
    seen = [e - s for name, s, e in run.trace.spans
            if re.search(pattern, name)]
    if not seen:
        raise MissingSpans(f"{kernel}: {calls} launches counted, no span "
                           f"matching {pattern!r} in the trace")
    per_call = max(1, round(len(seen) / calls))
    run.notes.append(f"{kernel}: {len(seen)} spans seen of "
                     f"{per_call * calls} launched ({calls} calls counted, "
                     f"{per_call} a call)")
    return sum(seen) / len(seen) * per_call * calls


def roofline_pct(run: Run, kernel: str, pattern: str) -> float | None:
    """The least time the window's launches of `kernel` need
    (`roofline/<kernel>.py`, from the reference's work on every frame
    coded) over their time."""
    took = kernel_ns(run, kernel, pattern)
    if took is None:
        return None
    work = importlib.import_module(f"benchmark.roofline.{kernel}")
    least = sum(work.least_seconds(run.expected[i], run.cfg)
                for i in run.images())
    return 100.0 * least * 1e9 / took


def copies_ms(run: Run, phase: int) -> float | None:
    """The PCIe copies' time (memcpy host to device and device to host)
    inside each request's encode (`phase` 0) or decode (1), in ms a
    request."""
    copies = [(s, e) for name, s, e in run.trace.spans
              if name.startswith(("Memcpy HtoD", "Memcpy DtoH"))]
    spans = sorted(r[phase] for r in run.trace.requests)
    if not copies or not spans:
        return None
    starts = [s for s, _ in spans]
    total = 0
    for s, e in copies:
        k = bisect.bisect_right(starts, s) - 1
        if k >= 0 and e <= spans[k][1]:
            total += e - s
    return total / len(spans) / 1e6


def idle_pct(run: Run) -> float | None:
    lo, hi = run.trace.window
    if not run.trace.spans or hi <= lo:
        return None
    busy = union_ns((s, e) for _, s, e in run.trace.spans)
    return 100.0 * (1 - busy / (hi - lo))
