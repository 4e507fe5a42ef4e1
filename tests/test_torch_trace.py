"""The port's observability (`picsong_tpu_torch/obs/trace.py`): the
union of device spans; `span` a shared no-op with no profiler recording;
the program's span tree over a CPU TorchCodec round trip, each wrapper and
read-back in its parent, per thread; the `READBACKS` counter; and
`device_trace` with no device time on the CPU."""

import glob
import json
import threading
from collections import Counter

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from picsong_tpu_torch.core.header import CodecConfig
from picsong_tpu_torch.core.lut import LUTParams, neutral_lut
from picsong_tpu_torch.engine.pipeline import TorchCodec
from picsong_tpu_torch.obs import trace
from picsong_tpu_torch.obs.trace import (busy_ms, device_spans, device_trace,
                                         span, union_ms)


@pytest.mark.parametrize("spans,want", [
    ([], 0.0),
    ([(0.0, 2.0), (1.0, 3.0)], 3.0),                  # overlapping
    ([(0.0, 10.0), (2.0, 3.0), (4.0, 9.5)], 10.0),    # nested
    ([(5.0, 6.0), (0.0, 1.5), (2.0, 2.25)], 2.75),    # disjoint, unsorted
    ([(0.0, 1.0), (1.0, 2.0), (1.5, 1.75)], 2.0),     # touching
], ids=["empty", "overlapping", "nested", "disjoint", "touching"])
def test_union_ms(spans, want):
    assert union_ms(spans) == want


def _codec(rgb: bool):
    """A 64x64 codec and an image of it: a checkerboard of 128 and 129
    (few bitplanes, so that the plain coder's ops stay few), shifted a
    component."""
    y, x = np.mgrid[0:64, 0:64]
    planes = [(128 + ((x + 16 * c) // 16 + y // 16) % 2).astype(np.uint8)
              for c in range(3 if rgb else 1)]
    params = LUTParams()
    luts = [neutral_lut(params, 1, 2)] * len(planes)
    codec = TorchCodec(CodecConfig(width=64, height=64, wavelet_levels=1,
                                   is_rgb=rgb, components=len(planes)),
                       luts, params, "cpu")
    return codec, planes if rgb else planes[0]


def _tree(prof) -> list[tuple[str, str | None, int]]:
    """(name, the innermost `picsong/` span around it in its thread or
    None, thread) of every `picsong/` span of a finished profile."""
    spans = sorted(((e.name(), e.start_ns(), e.end_ns(), e.start_thread_id())
                    for e in prof.profiler.kineto_results.events()
                    if e.is_user_annotation()
                    and e.name().startswith("picsong/")),
                   key=lambda s: (s[1], -s[2]))
    out = []
    for i, (name, lo, hi, tid) in enumerate(spans):
        parents = [p for p in spans[:i]
                   if p[3] == tid and p[1] <= lo and hi <= p[2]]
        out.append((name, parents[-1][0] if parents else None, tid))
    return out


# each span of a round trip, the span around it, and how many a component
TREE = {
    ("picsong/encode", None): 0,
    ("picsong/encode.upload", "picsong/encode"): 0,
    ("picsong/encode_planes", "picsong/encode"): 0,
    ("picsong/x2", "picsong/encode_planes"): 0,
    ("picsong/x2.read_max", "picsong/encode_planes"): 0,
    ("picsong/k1", "picsong/encode_planes"): 1,
    ("picsong/x3.pack", "picsong/encode"): 1,
    ("picsong/x3.pack.read_total", "picsong/x3.pack"): 1,
    ("picsong/encode.download", "picsong/encode"): 1,
    ("picsong/decode", None): 0,
    ("picsong/decode.upload", "picsong/decode"): 1,
    ("picsong/x3.unpack", "picsong/decode"): 1,
    ("picsong/decode_planes", "picsong/decode"): 0,
    ("picsong/k2", "picsong/decode_planes"): 1,
    ("picsong/x4", "picsong/decode_planes"): 0,
    ("picsong/decode.download", "picsong/decode"): 0,
}


def test_span_without_profiler_is_a_shared_no_op():
    """With no profiler recording, every span is the one no-op context,
    and a spanned call returns its function's result; under a profiler
    a span is a label of its own."""
    assert span("picsong/a") is span("picsong/b")
    with span("picsong/a") as entered:
        assert entered is None

    @trace.spanned("picsong/c")
    def twice(x):
        """Doubles."""
        return 2 * x

    assert twice(4) == 8 and twice.__doc__ == "Doubles."
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        assert span("picsong/a") is not span("picsong/a")
        assert twice(3) == 6
    assert span("picsong/a") is span("picsong/b")
    assert [name for name, _, _ in _tree(prof)] == ["picsong/c"]


@pytest.mark.parametrize("rgb", [False, True], ids=["gray", "rgb"])
def test_span_tree_cpu_round_trip(rgb):
    """Every span of the main path, in its parent, as often as the
    components call for."""
    codec, img = _codec(rgb)
    nc = 3 if rgb else 1
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        back = codec.decode(codec.encode(img))
    assert np.array_equal(np.asarray(back), np.asarray(img))
    got = Counter((name, parent) for name, parent, _ in _tree(prof))
    assert got == {k: nc if per else 1 for k, per in TREE.items()}


@pytest.mark.parametrize("rgb", [False, True], ids=["gray", "rgb"])
def test_readbacks_cpu_round_trip(rgb):
    """An encode reads the maximum once, and each component's payload
    total and codestream once; a decode reads each component's samples
    once. Counted with no profiler."""
    codec, img = _codec(rgb)
    nc = 3 if rgb else 1
    trace.reset_readbacks()
    streams = codec.encode(img)
    assert trace.READBACKS == 1 + nc + nc
    trace.reset_readbacks()
    codec.decode(streams)
    assert trace.READBACKS == nc
    trace.reset_readbacks()
    assert trace.READBACKS == 0


def test_spans_nest_per_thread(tmp_path):
    """Two threads open their spans in turns; each inner span's parent is
    its own thread's outer one."""
    turn = threading.Barrier(2, timeout=30)

    def work(tag):
        with span(f"picsong/outer.{tag}"):
            turn.wait()
            with span(f"picsong/inner.{tag}"):
                turn.wait()
            turn.wait()

    with device_trace(str(tmp_path), "cpu") as prof:
        other = threading.Thread(target=work, args=("b",))
        other.start()
        work("a")
        other.join(timeout=30)
    assert not other.is_alive()
    tree = _tree(prof)
    assert sorted((name, parent) for name, parent, _ in tree) == [
        ("picsong/inner.a", "picsong/outer.a"),
        ("picsong/inner.b", "picsong/outer.b"),
        ("picsong/outer.a", None), ("picsong/outer.b", None)]
    assert len({tid for _, _, tid in tree}) == 2


def test_device_trace_cpu_round_trip(tmp_path):
    codec, img = _codec(False)
    with device_trace(str(tmp_path / "trace"), "cpu") as prof:
        back = codec.decode(codec.encode(img))
    assert np.array_equal(back, img)
    (path,) = glob.glob(str(tmp_path / "trace" / "*.json"))
    with open(path) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert {name for name, _ in TREE} <= names
    assert busy_ms(prof) == (0.0, 0)


class _Event:
    """A profiler raw event: the methods `device_spans` reads."""

    def __init__(self, name, device, annotation, start_us, end_us):
        self._v = (name, device, annotation, start_us * 1000, end_us * 1000)

    def name(self):
        return self._v[0]

    def device_type(self):
        return self._v[1]

    def is_user_annotation(self):
        return self._v[2]

    def start_ns(self):
        return self._v[3]

    def end_ns(self):
        return self._v[4]


def test_busy_ms_counts_device_work_only():
    """Kernels, copies and memsets count; a span's label on the device
    (it covers the span's idle gaps too) and host ops do not."""
    cpu, cuda = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA
    events = [_Event("picsong/encode_planes", cuda, True, 0, 9000),
              _Event("picsong/encode_planes", cpu, True, 0, 9500),
              _Event("aten::add", cpu, False, 0, 100),
              _Event("bpc_encode_kernel", cuda, False, 1000, 1500),
              _Event("Memcpy DtoH (Device -> Pageable)", cuda, False,
                     1400, 2000),
              _Event("Memset (Device)", cuda, False, 5000, 5250)]

    class Prof:
        class profiler:
            class kineto_results:
                @staticmethod
                def events():
                    return events

    assert [s[0] for s in device_spans(Prof)] == [
        "bpc_encode_kernel", "Memcpy DtoH (Device -> Pageable)",
        "Memset (Device)"]
    assert busy_ms(Prof) == (1.25, 3)
