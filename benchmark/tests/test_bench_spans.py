"""The program's spans as the benchmark reads them (`harness/spans.py`).

On the CPU: the idle split, the wrappers' host time, the read-backs and
the card spans' re-anchoring on traces made by hand, with gaps split
across nested spans and the card's clock stepped within a run. On the
card (marker `cuda`): a short traced run of every cell prints each of the
spans' metrics; the layers' idle and the idle outside any program span add
up to the device's idle time a request; once re-anchored, every paired
kernel span lies between its wrapper call's start and its half request's
closing synchronisation; and the read-backs a request are exactly the
codec's.

    python -m pytest benchmark/tests/test_bench_spans.py -q -m cuda
"""

import json
import math
import subprocess
import sys
from pathlib import Path

import pytest

from benchmark.harness import cells, readers, spans
from benchmark.harness.trace import Trace

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
SPAN_METRICS = [m for m in BENCH["per_layer"]
                if m["source"] in ("program_span", "program_counter")]

# a request by hand, ns: the host's labels, the card's spans
LABELS = [("bench/window", 0, 1000), ("bench/encode", 0, 600),
          ("picsong/encode_planes", 10, 300), ("picsong/x2", 20, 100),
          ("picsong/x2.read_max", 110, 150), ("picsong/k1", 160, 200),
          ("picsong/x3.pack", 320, 420),
          ("picsong/x3.pack.read_total", 380, 410),
          ("bench/decode", 600, 1000), ("picsong/x3.unpack", 610, 650),
          ("picsong/decode_planes", 660, 900), ("picsong/k2", 670, 700),
          ("picsong/x4", 710, 760)]
DEVICE = [("void dwt_forward_kernel<false, 1>(Params)", 60, 130),
          ("void bpc_encode_kernel<2, false>(Args)", 190, 350),
          ("pack_kernel", 400, 405), ("unpack_kernel", 640, 660),
          ("void bpc_decode_kernel<2, false>(Args)", 690, 800),
          ("void dwt_reverse_kernel<false, 3>(Params)", 800, 850)]


def _run(labels=LABELS, device=DEVICE, launches=None):
    tr = Trace(spans=device, labels=sorted(labels, key=lambda x: x[1]),
               window=(0, 1000), requests=[((0, 600), (600, 1000))])
    return readers.Run(tr, launches or {"readbacks": 4}, [], None, 1)


def _requests(n=40, drift=0, after=0):
    """The made request n times over, a request a 1000 ns; the card's
    spans of requests `after` on recorded `drift` ns off."""
    labels, device, requests = [("bench/window", 0, 1000 * n)], [], []
    for r in range(n):
        t, d = 1000 * r, drift if r >= after else 0
        labels += [(x, s + t, e + t) for x, s, e in LABELS[1:]]
        device += [(x, s + t + d, e + t + d) for x, s, e in DEVICE]
        requests.append(((t, t + 600), (t + 600, t + 1000)))
    return Trace(spans=device, labels=sorted(labels, key=lambda x: x[1]),
                 window=(0, 1000 * n), requests=requests)


def test_layer_of():
    assert [spans.layer_of(n) for n in (
        "picsong/x2", "picsong/x2.read_max", "picsong/x3.pack.read_total",
        "picsong/x3.unpack", "picsong/encode.download", "picsong/decode",
        "bench/pack")] == ["x2", "x2", "x3_pack", "x3_unpack", "codec",
                           "codec", None]


def test_spans_on_a_made_trace():
    """Idle gaps (0-60, 130-190, 350-400, 405-640, 660-690, 850-1000)
    split by the innermost program span over each piece; a read-back
    under its wrapper; what no program span covers, outside."""
    run = _run()
    assert spans.idle_split(run.trace) == {
        "x2": 40 + 20, "k1": 30, "x3_pack": 30 + 20 + 15, "x3_unpack": 30,
        "k2": 20, "x4": 0, "codec": 10 + 10 + 10 + 50,
        "outside": 10 + 190 + 100}
    assert spans.idle_ms(run, "x3_pack") == 65 / 1e6
    assert spans.idle_ms(run, "codec") == 80 / 1e6
    (note,) = run.notes
    assert note.startswith(spans.NOTE)
    got = json.loads(note[len(spans.NOTE):])
    assert got["requests"] == 1 and got["device_idle_ms"] == 585 / 1e6
    assert got["anchored_idle_ms"] == 585 / 1e6
    assert sum(got["idle_ms"].values()) == pytest.approx(585 / 1e6)
    assert got["kernel_spans"] == got["after_their_wrapper"] == 6
    assert got["anchored"] == 6 and got["moved"] == 0
    # the wrapper's span less its read-back: 100 - 30 ns
    assert spans.host_us(run, "x3_pack") == 70 / 1e3
    assert spans.host_us(run, "x2") == 80 / 1e3
    assert spans.readbacks(run) == 4


def test_a_kernel_before_its_wrapper_moves_the_stretch():
    """K2's call recorded 60 ns late: its kernel starts 40 ns before it.
    One stretch of both halves, no half at offset 0: the least offset that
    meets the bounds, 40 ns."""
    late = [(n, s + 60 if n == "picsong/k2" else s,
             e + 60 if n == "picsong/k2" else e) for n, s, e in LABELS]
    moved, got = spans.anchored(_run(late).trace)
    assert got == {"kernel_spans": 6, "after_their_wrapper": 5,
                   "anchored": 6, "halves": 2, "moved": 2,
                   "offset_us": [0.04, 0.04], "lead_us": 0.0,
                   "bound_us": 0.11, "disagree": 0, "unpaired": []}
    assert moved.spans == [(n, s + 40, e + 40) for n, s, e in DEVICE]


@pytest.mark.parametrize("drift,after", [(-250, 20), (300, 10)],
                         ids=["early", "late"])
def test_anchoring_restores_a_stepped_clock(drift, after):
    """The card's spans recorded 250 ns early (before their wrappers,
    over the next request's) or 300 ns late from a request on: the
    re-anchored split is the clean one, to the ns; the recorded one is
    not."""
    clean = spans.idle_split(_requests())
    stepped = _requests(drift=drift, after=after)
    assert spans.idle_split(stepped) != clean
    moved, got = spans.anchored(stepped)
    assert spans.idle_split(moved) == clean
    assert moved.spans == _requests().spans
    assert got["anchored"] == got["kernel_spans"] == 240
    assert got["moved"] == 2 * (40 - after)
    assert got["offset_us"] == sorted([0, -drift / 1e3])
    assert got["lead_us"] == 0.02 and got["disagree"] == 0


def test_anchoring_with_no_stretch_at_offset_0():
    """Every card span 250 ns early: no stretch reads the kernels' lead
    over their wrappers, so each moves by the least that meets the bounds
    (230 ns: K2 20 ns after its call's start)."""
    moved, got = spans.anchored(_requests(drift=-250))
    assert moved.spans == [(n, s - 20, e - 20)
                           for n, s, e in _requests().spans]
    assert got["offset_us"] == [0.23, 0.23] and got["lead_us"] == 0.0
    assert got["anchored"] == got["kernel_spans"]


def test_anchoring_leaves_out_a_kernel_with_a_dropped_span():
    """Two K1 calls, one K1 span: K1 is not paired; the rest are."""
    lost = _requests(n=2, drift=-250)
    lost.spans.pop(1)
    moved, got = spans.anchored(lost)
    assert got["unpaired"] == ["k1"] and got["kernel_spans"] == 10
    assert got["anchored"] == 10 and got["offset_us"] == [0.23, 0.23]


def test_kernel_patterns_are_the_rooflines():
    """The kernels are matched as each `metrics/<kernel>_roofline.py`
    matches them, read from its call."""
    for key in spans.WRAPPERS:
        module = cells.by_name(spans.METRICS, f"{key}_roofline")
        module.roofline_pct = lambda run, kernel, pattern: (kernel, pattern)
        assert module.read(None) == (key, spans.kernel_pattern(key))


def test_readbacks_without_the_counter():
    """A program without `READBACKS` counts NaN: no reading; a count of
    0 reads 0."""
    assert spans.readbacks(_run(launches={"readbacks": math.nan})) is None
    assert spans.readbacks(_run(launches={"readbacks": 0})) == 0


def test_nothing_without_program_spans_or_device_spans():
    bench_only = [x for x in LABELS if x[0].startswith("bench/")]
    older = _run(bench_only)
    assert spans.idle_ms(older, "x2") is None
    assert spans.host_us(older, "k1") is None
    assert older.notes == []
    cpu = _run(device=[])
    assert spans.idle_ms(cpu, "codec") is None
    assert spans.host_us(cpu, "k1") is None
    assert spans.readbacks(cpu) is None


@pytest.mark.cuda
@pytest.mark.parametrize("workload", [w["name"] for w in BENCH["workloads"]])
def test_cell_spans(cuda, workload):
    proc = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", workload,
         "--seed", str(2 ** 31 + 21), "--seconds", "2", "--trace", "1"],
        cwd=ROOT, capture_output=True, text=True, timeout=360)
    assert proc.returncode == 0, proc.stderr[-2000:]
    lines = proc.stdout.strip().splitlines()
    result = json.loads(lines[-1])
    assert result["correct"] is True
    metrics = {k: v["value"] for k, v in result["metrics"].items()}
    want = {m["name"] for m in SPAN_METRICS
            if workload in m.get("workloads", [workload])}
    assert want and want <= set(metrics)
    assert all(metrics[m] is not None for m in want)
    cell = next(w for w in BENCH["workloads"] if w["name"] == workload)
    config = next(c for c in BENCH["configs"] if c["name"] == cell["config"])
    rgb = json.loads((ROOT / config["file"]).read_text())["is_rgb"]
    assert metrics["readbacks"] == 1 + (3 if rgb else 1)
    (note,) = [x for x in lines if x.startswith(spans.NOTE)]
    split = json.loads(note[len(spans.NOTE):])
    layers = sum(v for k, v in metrics.items() if k.startswith("idle_ms."))
    idle = (metrics["device_idle_pct"] / 100 * result["device"]["window_s"]
            * 1e3 / split["requests"])
    assert layers + split["idle_ms"]["outside"] == pytest.approx(idle,
                                                                 rel=0.02)
    assert split["kernel_spans"] > 0 and split["unpaired"] == []
    assert split["anchored"] >= 0.999 * split["kernel_spans"]
