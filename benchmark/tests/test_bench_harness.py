"""A run end to end on the CPU at tiny sizes: the result line, the numbers
compared, and `correct` false under the control and under each fault the
cells can have, planted in the program underneath the harness."""

import json

import pytest
import torch

from benchmark import run as bench_run
from picsong_tpu_torch.assembly import pack
from picsong_tpu_torch.entropy import bpc_cuda
from picsong_tpu_torch.transform import dwt_cuda

KEYS = {"correct", "attempted", "failed", "metrics", "device"}


def _run(capsys, bench, workload, *extra):
    rc = bench_run.main(["--workload", workload, "--seed", "4294967311",
                         "--seconds", "0.2", "--device", "cpu",
                         "--bench", str(bench), *extra])
    out, err = capsys.readouterr()
    assert rc == 0, err[-2000:]
    result = json.loads(out.strip().splitlines()[-1])
    return result, err


@pytest.mark.parametrize("workload", ["g.host", "r.device"])
def test_cell_end_to_end(capsys, tiny_bench, workload):
    result, err = _run(capsys, tiny_bench, workload, "--trace", "0")
    assert KEYS <= result.keys() and list(result)[-1] == "checks"
    assert result["correct"] is True
    assert result["attempted"] >= 1 and result["failed"] == 0
    assert set(result["metrics"]) == {"mpix_s", "encode_p95_ms",
                                      "decode_p95_ms", "setup_s"}
    assert all(m["value"] > 0 for m in result["metrics"].values())
    assert result["device"]["platform"] == "cpu"
    checks = result["checks"]
    assert checks == {"codestream_diff_shorts": {"value": 0, "limit": 0},
                      "decoded_diff_samples": {"value": 0, "limit": 0}}
    assert err.strip().splitlines()[-2:] == [
        "check codestream_diff_shorts = 0 (limit 0)",
        "check decoded_diff_samples = 0 (limit 0)"]


def test_traced_cell(capsys, tiny_bench):
    """`--trace 1` prints per-layer metrics only (none on the CPU: no
    device spans, no kernel launches) and the trace's window."""
    result, _ = _run(capsys, tiny_bench, "l.device", "--trace", "1")
    assert result["correct"] is True
    assert result["metrics"] == {}
    assert result["device"]["window_s"] > 0
    assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}


def test_control_is_not_correct(capsys, tiny_bench):
    for workload in ("g.host", "l.device"):
        result, _ = _run(capsys, tiny_bench, workload, "--system", "control")
        assert result["correct"] is False
        assert result["checks"]["codestream_diff_shorts"]["value"] > 0
        assert result["checks"]["decoded_diff_samples"]["value"] > 0


def _stale_pack(monkeypatch):
    """A step that returns its state unchanged: the pack hands out its
    first codestream again and again."""
    real, first = pack.pack_streams, []

    def stale(*a, **k):
        if not first:
            first.append(real(*a, **k))
        return first[0].clone()
    monkeypatch.setattr(pack, "pack_streams", stale)


def _half_batch(monkeypatch):
    """Half of the batch left out: K1 codes the first half of the
    codeblocks, the rest leave as empty blocks."""
    real = bpc_cuda.encode_blocks

    def half(blocks, *a, **k):
        streams, sizes = real(blocks, *a, **k)
        h = blocks.shape[0] // 2
        streams[h:] = -1
        streams[h:, 0] = 32
        sizes[h:] = 1
        return streams, sizes
    monkeypatch.setattr(bpc_cuda, "encode_blocks", half)


def _altered_sample(monkeypatch):
    """An answer altered where it is produced: X4 gives one sample off by
    one."""
    real = dwt_cuda.reverse

    def altered(*a, **k):
        planes = real(*a, **k)
        planes[0].view(-1)[7] ^= 1
        return planes
    monkeypatch.setattr(dwt_cuda, "reverse", altered)


# the exchange between chips is a fault no cell can have: every cell runs
# on one card
@pytest.mark.parametrize("fault", [_stale_pack, _half_batch, _altered_sample])
@pytest.mark.parametrize("workload", ["r.host", "r.device"])
def test_fault_is_not_correct(capsys, monkeypatch, tiny_bench, fault,
                              workload):
    fault(monkeypatch)
    result, _ = _run(capsys, tiny_bench, workload)
    assert result["correct"] is False
    assert result["failed"] >= 1
    checks = result["checks"]
    assert (checks["codestream_diff_shorts"]["value"]
            + checks["decoded_diff_samples"]["value"]) > 0


def test_no_card_means_no_result(capsys):
    """Without a card (this machine) a run exits non-zero and prints no
    result."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    rc = bench_run.main(["--workload", "rgb_lossless.device", "--seed", "1",
                         "--seconds", "1"])
    out, err = capsys.readouterr()
    assert rc != 0 and out == "" and "needs 1 CUDA device" in err


def test_readers_on_a_made_trace():
    """The readers' arithmetic on a trace made by hand: a kernel's time is
    its spans' mean times the launches counted (a span dropped), a kernel
    counted but never seen fails the run, PCIe copies count inside their
    request's phase only, and idle is the window less the spans' union."""
    from benchmark.harness import readers
    from benchmark.harness.trace import Trace

    k1 = "bpc_encode_kernel<2, false>"
    tr = Trace(spans=[(k1, 0, 10), (k1, 20, 40),
                      ("Memcpy HtoD (Pageable -> Device)", 40, 50),
                      ("Memcpy DtoH (Device -> Pageable)", 60, 64),
                      ("Memcpy HtoD (Pageable -> Device)", 95, 99)],
               labels=[], window=(0, 100), requests=[((0, 55), (55, 70))])
    run = readers.Run(tr, {"k1": 3, "k2": 0}, [], None, 1)
    assert readers.kernel_ns(run, "k1", r"\bbpc_encode_kernel\b") == 45
    assert readers.kernel_ns(run, "k2", r"\bbpc_decode_kernel\b") is None
    with pytest.raises(readers.MissingSpans):
        readers.kernel_ns(readers.Run(tr, {"k2": 1}, [], None, 1), "k2",
                          r"\bbpc_decode_kernel\b")
    assert readers.copies_ms(run, 0) == 10 / 1e6
    assert readers.copies_ms(run, 1) == 4 / 1e6
    assert readers.idle_pct(run) == 52.0
