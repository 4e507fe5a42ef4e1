"""Spans, the read-back counter and the device trace.

Counterpart of `picsong_tpu.obs.trace`:

- `span(name)` is a `torch.profiler.record_function` label while a
  profiler records, and one shared no-op context otherwise: with no
  profiler it costs the profiler's own enabled flag and a `with`.
  `spanned(name)` puts a span around every call of a function. The
  profiler keeps the spans in memory on the clock of the card's kernel
  and memcpy spans and writes them out with its trace; a span opened in a
  thread nests in that thread's open span. The program's spans, all under
  `picsong/`, sit at each layer boundary of the main path: the codec's
  `encode` / `decode` (with their `.upload` / `.download` children) and
  `encode_planes` / `decode_planes`; the kernels' wrappers `x2`, `k1`,
  `x3.pack`, `x3.unpack`, `k2`, `x4`; and the reads that block the host
  on a device value: `x2.read_max`, `x3.pack.read_total` and the host
  path's downloads.
- `READBACKS` counts those blocking reads, always: `readback(name,
  count)` is the span of such a read and adds `count`.
- `device_trace(log_dir, device)` wraps `torch.profiler.profile` (the
  counterpart of `jax.profiler.trace`), every thread's spans included, and
  writes a Chrome trace JSON into `log_dir` on exit.
- `busy_ms(prof)` is the device's busy time in such a trace: the union of
  its kernel, memcpy and memset spans (`device_spans`).

A span around asynchronous CUDA work times the host's enqueue, not the
device: the device's time is read from the trace.
"""

from __future__ import annotations

import contextlib
import functools
import os
import tempfile

import torch
from torch.autograd import profiler as _profiler

READBACKS = 0

_OFF = contextlib.nullcontext()


def reset_readbacks() -> None:
    global READBACKS
    READBACKS = 0


def span(name: str):
    """A profiler label `name` around the block while a profiler records
    (the flag is the profiler's own, set for every thread); else a shared
    no-op context."""
    if _profiler._is_profiler_enabled:
        return torch.profiler.record_function(name)
    return _OFF


def spanned(name: str):
    """Decorate a function so that each call runs in `span(name)`; with
    no profiler recording, the call goes straight through after the
    flag's test."""
    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            if not _profiler._is_profiler_enabled:
                return fn(*args, **kwargs)
            with torch.profiler.record_function(name):
                return fn(*args, **kwargs)
        return call
    return wrap


def readback(name: str, count: int = 1):
    """`span(name)` around `count` reads that block the host on the
    device, added to `READBACKS`."""
    global READBACKS
    READBACKS += count
    return span(name)


@contextlib.contextmanager
def device_trace(log_dir: str, device="cuda"):
    """Profile the block: host activity in every thread always, the CUDA
    device's kernels and copies when `device` is a CUDA device. Yields the
    profiler; on exit writes its Chrome trace (a new `trace_*.json`,
    viewable in Perfetto) into `log_dir`."""
    from torch._C._profiler import _ExperimentalConfig
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities, experimental_config=(
            _ExperimentalConfig(profile_all_threads=True))) as prof:
        yield prof
    fd, path = tempfile.mkstemp(prefix="trace_", suffix=".json", dir=log_dir)
    os.close(fd)
    prof.export_chrome_trace(path)


def union_ms(spans) -> float:
    """Total length of the union of (start, end) intervals, in their
    unit."""
    total, end = 0.0, float("-inf")
    for lo, hi in sorted(spans):
        total += max(0.0, hi - max(lo, end))
        end = max(end, hi)
    return total


def device_spans(prof) -> list[tuple[str, float, float]]:
    """(name, start ms, end ms) of each CUDA kernel, memcpy and memset
    event of a finished profile (none on the CPU). A `record_function`
    label also has a span on the device's timeline, from its first to its
    last device op, idle gaps included: those are left out. Reads the
    profiler's raw events: `prof.events()` would first build a Python
    event tree, seconds for every 10^5 host ops."""
    cuda = torch.autograd.DeviceType.CUDA
    return [(e.name(), e.start_ns() / 1e6, e.end_ns() / 1e6)
            for e in prof.profiler.kineto_results.events()
            if e.device_type() == cuda and not e.is_user_annotation()]


def busy_ms(prof) -> tuple[float, int]:
    """The device's busy time in a finished profile, in ms, and its span
    count: the union of its kernel, memcpy and memset spans (0.0 and 0
    when the profiler saw no device activity, as on the CPU)."""
    spans = device_spans(prof)
    return union_ms((lo, hi) for _, lo, hi in spans), len(spans)
