"""Requests that code several frames, on the CPU at tiny sizes: a mix's
`frames_per_request` F, written into this test's own tree beside the tiny
cells, runs through `run.py` with the `device` entry coding each of its F
pool images through `TorchCodec`. `mpix_s` counts every frame, a roofline
every frame's work, the reservoir keeps `keep` frames drawn over every
frame position, and a fault in the last frame of a request alone reads
`correct` false. With one frame a request (no key) the run reads as the
harness did before frames: the same arithmetic and the same kept set."""

import json
import random
import shutil

import numpy as np
import pytest

from benchmark import run as bench_run
from benchmark.harness import images, loop, readers
from benchmark.harness.trace import Trace
from benchmark.reference import codec as reference
from picsong_tpu_torch.assembly import pack
from picsong_tpu_torch.engine.pipeline import TorchCodec

F = 3
SEED = 4294967311


@pytest.fixture(scope="module")
def frames_bench(tmp_path_factory, tiny_bench):
    """The tiny bench with a mix of F frames a request and a cell of it."""
    d = tmp_path_factory.mktemp("frames")
    shutil.copytree(tiny_bench.parent, d, dirs_exist_ok=True)
    mix = json.loads((d / "benchmark/traffic/device.json").read_text())
    mix.update(frames_per_request=F, keep=4)
    (d / "benchmark/traffic/frames.json").write_text(json.dumps(mix))
    bench = json.loads((d / "BENCHMARK.json").read_text())
    bench["workloads"].append({"name": "r.frames", "config": "tiny_rgb",
                               "traffic": "frames", "chips": 1,
                               "why": "test"})
    for m in bench["per_layer"]:
        m["workloads"].append("r.frames")
    path = d / "BENCHMARK.json"
    path.write_text(json.dumps(bench))
    return path


def _config(bench, workload):
    from benchmark.harness import cells
    return cells.load_cell(workload, bench).config


def _run(capsys, monkeypatch, bench, workload, *extra, seconds="0.2"):
    """One run; the window and the reservoir the loop filled, and the
    `readers.Run` of a traced run, caught on their way."""
    seen = {}
    real_run, real_reader = loop.run, readers.Run

    def run(entry, n_images, frames, secs, reservoir, device):
        seen.update(n_images=n_images, frames=frames, reservoir=reservoir)
        seen["window"] = real_run(entry, n_images, frames, secs, reservoir,
                                  device)
        return seen["window"]

    def reader(*a, **k):
        seen["run"] = real_reader(*a, **k)
        return seen["run"]
    monkeypatch.setattr(loop, "run", run)
    monkeypatch.setattr(readers, "Run", reader)
    rc = bench_run.main(["--workload", workload, "--seed", str(SEED),
                         "--seconds", seconds, "--device", "cpu",
                         "--bench", str(bench), *extra])
    out, err = capsys.readouterr()
    assert rc == 0, err[-2000:]
    return json.loads(out.strip().splitlines()[-1]), seen


def test_mpix_counts_every_frame(capsys, monkeypatch, frames_bench):
    """(a) mpix_s = F x w x h x requests / seconds; every frame correct."""
    result, seen = _run(capsys, monkeypatch, frames_bench, "r.frames",
                        "--trace", "0")
    assert result["correct"] is True and result["failed"] == 0
    window, cfg = seen["window"], _config(frames_bench, "r.frames")
    n = len(window.encode_s)
    assert seen["frames"] == F and window.frames == F * n
    assert result["metrics"]["mpix_s"]["value"] == pytest.approx(
        F * cfg["width"] * cfg["height"] * n / 1e6 / window.seconds,
        rel=1e-12)
    kept = seen["reservoir"].items
    assert len(kept) == min(4, F * n)
    for position, request, image, _ in kept:
        assert request == position // F
        assert image == images.of_request(request, F,
                                          seen["n_images"])[position % F]


def test_traced_run_lists_every_frame(capsys, monkeypatch, frames_bench):
    """(b) in a traced run, `Run.images()` lists F frames a request."""
    result, seen = _run(capsys, monkeypatch, frames_bench, "r.frames",
                        "--trace", "1")
    assert result["correct"] is True
    run = seen["run"]
    requests = len(run.trace.requests)
    assert requests == len(seen["window"].encode_s) >= 1
    assert run.frames == F
    assert run.images() == [(i * F + j) % seen["n_images"]
                            for i in range(requests) for j in range(F)]


@pytest.mark.parametrize("frames", [1, F])
def test_roofline_sums_every_frame(frames):
    """(b) a roofline's least time is the reference's work summed over
    every frame of every request: X2's is one frame's times the frames."""
    cfg = reference.Config(width=128, height=64, components=1, is_rgb=True,
                           bit_depth=8, bps=8, is_signed=False, endianess=0,
                           is_lossy=False, qs=1.0, wavelet_levels=2,
                           coding_passes=2, k_factor=0.0, cb_height=18,
                           cb_width=64)
    kernel = "void dwt_forward_kernel<false, 1>(Params)"
    tr = Trace(spans=[(kernel, 100 * k, 100 * k + 50) for k in range(4)],
               labels=[], window=(0, 400),
               requests=[((100 * k, 100 * k + 60), (100 * k + 60, 100 * k
                                                     + 100))
                         for k in range(4)])
    run = readers.Run(tr, {"x2": 4}, [None] * 5, cfg, 5, frames)
    assert run.images() == [(i * frames + j) % 5 for i in range(4)
                            for j in range(frames)]
    from benchmark.roofline import dwt
    assert readers.roofline_pct(run, "x2", r"\bdwt_forward_kernel\b") \
        == pytest.approx(100 * 4 * frames * dwt.least_seconds(cfg) * 1e9
                         / 200, rel=1e-12)


def _offers(keep, frames, requests, seed):
    res = loop.Reservoir(keep, seed)
    like = [np.zeros(2, np.int64)]
    res.size(like)
    res.allocate(like)
    for i in range(requests):
        for j in range(frames):
            p = i * frames + j
            res.offer(p, i, p % 7, [np.array([p, -p], np.int64)])
    return res


def test_reservoir_keeps_frames():
    """(c) over many requests the reservoir keeps `keep` frames, copied
    whole into its `keep` buffers; over seeds every frame position of a
    request is drawn about equally often, early requests as late ones."""
    keep, requests, seeds = 5, 60, 400
    by_position, early = [0] * F, 0
    for seed in range(seeds):
        res = _offers(keep, F, requests, seed)
        assert len(res.items) == len(res.slots) == keep
        for (r, image, (part,)), (p, _, _, _) in zip(res.outputs(),
                                                     res.items):
            assert r == p // F and image == p % 7
            assert part.tolist() == [p, -p]
            by_position[p % F] += 1
            early += r < requests // 2
    total = keep * seeds
    assert all(abs(c - total / F) < 0.1 * total / F for c in by_position)
    assert abs(early - total / 2) < 0.1 * total / 2


def test_reservoir_one_frame_draws_as_before():
    """(e) one frame a request: the kept (request, image) pairs are those
    of the harness before frames, whose reservoir drew over requests."""
    for seed in (SEED, 7, 2 ** 40 + 1):
        assert [(r, image) for _, r, image, _ in
                _offers(12, 1, 500, seed).items] == _before(12, 500, 7,
                                                            seed)


def _before(keep, requests, n_images, seed):
    """The kept (request, image) of the reservoir before frames, by its own
    code: algorithm R over the requests' indices."""
    rng, items = random.Random(seed), []
    for i in range(requests):
        if len(items) < keep:
            items.append((i, i % n_images))
            continue
        j = rng.randrange(i + 1)
        if j < keep:
            items[j] = (i, i % n_images)
    return items


def test_one_frame_reads_as_before(capsys, monkeypatch, tiny_bench):
    """(e) a mix with no `frames_per_request`: the same metrics by the
    same arithmetic (`mpix_s` = requests x w x h / seconds, to the last
    bit), and the same requests kept for the seed."""
    result, seen = _run(capsys, monkeypatch, tiny_bench, "r.device",
                        "--trace", "0")
    assert result["correct"] is True
    window, cfg = seen["window"], _config(tiny_bench, "r.device")
    n = len(window.encode_s)
    assert seen["frames"] == 1 and window.frames == n
    assert set(result["metrics"]) == {"mpix_s", "encode_p95_ms",
                                      "decode_p95_ms", "setup_s"}
    assert result["metrics"]["mpix_s"]["value"] == (
        n * cfg["width"] * cfg["height"] / 1e6 / window.seconds)
    assert [(r, image) for _, r, image, _ in seen["reservoir"].items] \
        == _before(2, n, seen["n_images"], SEED)


def _last_frame_sample(monkeypatch):
    """A decoded sample altered where it is produced, in the last frame of
    each request only (a request decodes its frames in turn)."""
    real, calls = TorchCodec.decode_planes, [0]

    def altered(self, *a, **k):
        planes = real(self, *a, **k)
        calls[0] += 1
        if calls[0] % F == 0:
            planes[0].view(-1)[7] ^= 1
        return planes
    monkeypatch.setattr(TorchCodec, "decode_planes", altered)


def _last_frame_code(monkeypatch):
    """A codestream's closing word altered where it is produced, in the
    last frame of each request only (three components a frame): the
    decode, which never reads it, runs on."""
    real, calls = pack.pack_streams, [0]

    def altered(*a, **k):
        code = real(*a, **k)
        calls[0] += 1
        if (calls[0] - 1) // 3 % F == F - 1:
            code[-1] ^= 1
        return code
    monkeypatch.setattr(pack, "pack_streams", altered)


@pytest.mark.parametrize("fault", [_last_frame_sample, _last_frame_code])
def test_fault_in_the_last_frame_is_not_correct(capsys, monkeypatch,
                                                frames_bench, fault):
    """(d) one request in the window (`--seconds 0`), all its F frames
    kept: a fault in frame F - 1 alone reads `correct` false."""
    fault(monkeypatch)
    result, seen = _run(capsys, monkeypatch, frames_bench, "r.frames",
                        seconds="0")
    assert len(seen["window"].encode_s) == 1
    assert sorted(p for p, *_ in seen["reservoir"].items) == list(range(F))
    assert result["correct"] is False and result["failed"] == 1
    checks = result["checks"]
    assert (checks["codestream_diff_shorts"]["value"]
            + checks["decoded_diff_samples"]["value"]) > 0


def test_control_of_frames_is_not_correct(capsys, monkeypatch, frames_bench):
    """(d) the control in the program's place, F frames a request."""
    result, _ = _run(capsys, monkeypatch, frames_bench, "r.frames",
                     "--system", "control")
    assert result["correct"] is False
    assert result["checks"]["codestream_diff_shorts"]["value"] > 0
    assert result["checks"]["decoded_diff_samples"]["value"] > 0


def test_frames_handed_back_must_be_the_requests():
    """An entry that hands back fewer frames than its request's, or
    another image's, fails the request; one without `frames` codes one."""
    class Entry:
        @staticmethod
        def frames(images, encoded, decoded):
            return [(image, []) for image in images[:-1]]

    with pytest.raises(ValueError):
        loop.frames_of(Entry(), [0, 1, 2], None, None)

    class OneFrame:
        @staticmethod
        def parts(encoded, decoded):
            return [encoded, decoded]

    assert loop.frames_of(OneFrame(), [4], 1, 2) == [(4, [1, 2])]
    with pytest.raises(ValueError):
        loop.frames_of(OneFrame(), [4, 5], 1, 2)
