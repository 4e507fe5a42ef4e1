"""The port's multi-host video (`dist/multihost.py`): every case of
tests/test_multihost.py. Slab partition, rank-ordered merges equal to the
single-host file (and to the JAX engine's), slab decode, scaling
accounting; hosts are simulated one after the other in this process (the
data plane has no cross-host dependency, so that is exact), and once for
real: two processes in a gloo process group (tests/torch_mp_worker.py).

Files and `_SIZE` sidecars are compared byte for byte (tolerance 0); the
port runs on the CPU.
"""

import os
import socket
import subprocess
import sys
import time

import numpy as np
import torch

from picsong_tpu.engine import video as jvideo
from picsong_tpu_torch.core.header import CodecConfig
from picsong_tpu_torch.core.image_io import read_raw_frame
from picsong_tpu_torch.core.lut import LUTParams, neutral_lut
from picsong_tpu_torch.dist.multihost import (ScalingReport,
                                              decode_video_part,
                                              encode_video_part, frame_slab,
                                              init_distributed, merge_parts,
                                              merge_raw_parts, rank_and_size)
from picsong_tpu_torch.engine.video import decode_video, encode_video

from torch_twins import J

PARAMS = LUTParams()


def make_image(rng, h, w):
    y, x = np.mgrid[0:h, 0:w]
    base = (96 + 64 * np.sin(x / 9.0) * np.cos(y / 13.0)
            + rng.normal(0, 8, size=(h, w)))
    return np.clip(base, 0, 255).astype(np.uint8)


def read(path):
    with open(path, "rb") as f:
        return f.read()


def write_video(path, frames):
    with open(path, "wb") as f:
        for fr in frames:
            f.write(fr.tobytes())


def test_frame_slab_partition():
    for frames, hosts in ((10, 3), (8, 8), (5, 8), (2090, 4), (7, 1)):
        ranges = [frame_slab(frames, hosts, h) for h in range(hosts)]
        covered = []
        for start, stop in ranges:
            covered.extend(range(start, stop))
        assert covered == list(range(frames)), (frames, hosts, ranges)
        lens = [stop - start for start, stop in ranges]
        assert max(lens) - min(lens) <= 1   # balanced slabs


def test_init_distributed_single_process(monkeypatch):
    monkeypatch.delenv("MASTER_ADDR", raising=False)
    assert init_distributed() == (0, 1)
    assert rank_and_size() == (0, 1)


def test_multihost_merge_matches_single_host(tmp_path):
    """3 simulated hosts over 7 frames: the merged file and `_SIZE` equal
    the single-host port's and the JAX engine's, and decode back."""
    rng = np.random.default_rng(0)
    frames = [make_image(rng, 64, 128) for _ in range(7)]
    raw = str(tmp_path / "v.raw")
    write_video(raw, frames)
    cfg = CodecConfig(width=128, height=64, wavelet_levels=1, frames=7)
    luts = [neutral_lut(PARAMS, 1, 2)]

    single, jax = str(tmp_path / "single.enc"), str(tmp_path / "jax.enc")
    encode_video(raw, single, cfg, luts, PARAMS, frames=7, batch=2,
                 device="cpu")
    jvideo.encode_video(raw, jax, J(cfg), luts, J(PARAMS), frames=7, batch=2)

    merged = str(tmp_path / "merged.enc")
    hosts = 3
    for h in range(hosts):
        encode_video_part(raw, merged, cfg, luts, PARAMS, frames=7,
                          num_hosts=hosts, host_id=h, batch=2, device="cpu")
    merge_parts(merged, hosts)
    for want in (single, jax):
        assert read(merged) == read(want)
        assert read(merged + "_SIZE") == read(want + "_SIZE")
    assert not os.path.exists(merged + ".part0")

    dec = str(tmp_path / "dec.raw")
    decode_video(merged, dec, cfg, luts, PARAMS, batch=2, device="cpu")
    for i, fr in enumerate(frames):
        assert np.array_equal(read_raw_frame(dec, 128, 64, i), fr)


def test_multihost_more_hosts_than_frames(tmp_path):
    rng = np.random.default_rng(1)
    frames = [make_image(rng, 64, 64) for _ in range(2)]
    raw = str(tmp_path / "v.raw")
    write_video(raw, frames)
    cfg = CodecConfig(width=64, height=64, wavelet_levels=1, frames=2)
    luts = [neutral_lut(PARAMS, 1, 2)]
    merged = str(tmp_path / "m.enc")
    for h in range(4):
        encode_video_part(raw, merged, cfg, luts, PARAMS, frames=2,
                          num_hosts=4, host_id=h, batch=2, device="cpu")
    merge_parts(merged, 4)
    dec = str(tmp_path / "dec.raw")
    decode_video(merged, dec, cfg, luts, PARAMS, batch=2, device="cpu")
    for i, fr in enumerate(frames):
        assert np.array_equal(read_raw_frame(dec, 64, 64, i), fr)


def test_multihost_decode_slab_matches_single(tmp_path):
    """decode_video_part + merge_raw_parts: per-host slab decode through
    the `_SIZE` prefix offsets gives the single-host raw output."""
    rng = np.random.default_rng(5)
    frames = [make_image(rng, 64, 128) for _ in range(7)]
    raw = str(tmp_path / "v.raw")
    write_video(raw, frames)
    cfg = CodecConfig(width=128, height=64, wavelet_levels=1, frames=7)
    luts = [neutral_lut(PARAMS, 1, 2)]
    enc = str(tmp_path / "v.enc")
    encode_video(raw, enc, cfg, luts, PARAMS, frames=7, batch=2,
                 device="cpu")

    merged = str(tmp_path / "dec.raw")
    hosts = 3
    for h in range(hosts):
        decode_video_part(enc, merged, cfg, luts, PARAMS, num_hosts=hosts,
                          host_id=h, batch=2, device="cpu")
    merge_raw_parts(merged, hosts)

    single = str(tmp_path / "dec_single.raw")
    decode_video(enc, single, cfg, luts, PARAMS, batch=2, device="cpu")
    assert read(merged) == read(single)
    assert read(merged) == read(raw)      # lossless: the input frames


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def test_real_multiprocess_distributed(tmp_path):
    """Two processes in a gloo process group run the multi-host encode and
    decode through init_distributed, the barriers and the rank-0 merges:
    the files equal the single-host port's and the JAX engine's, and no
    worker outlives the test."""
    rng = np.random.default_rng(7)
    frames = [make_image(rng, 64, 64) for _ in range(5)]
    raw = str(tmp_path / "v.raw")
    write_video(raw, frames)
    cfg = CodecConfig(width=64, height=64, wavelet_levels=1, frames=5)
    luts = [neutral_lut(PARAMS, 1, 2)]
    single, jax = str(tmp_path / "single.enc"), str(tmp_path / "jax.enc")
    encode_video(raw, single, cfg, luts, PARAMS, frames=5, batch=2,
                 device="cpu")
    jvideo.encode_video(raw, jax, J(cfg), luts, J(PARAMS), frames=5, batch=2)

    port = _free_port()
    worker = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "torch_mp_worker.py")
    repo = os.path.dirname(os.path.dirname(worker))
    env = {k: v for k, v in os.environ.items()
           if k not in ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE")}
    procs = [subprocess.Popen(
        [sys.executable, worker, str(pid), "2", str(port), str(tmp_path)],
        cwd=repo, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        for pid in range(2)]
    try:
        for pid, p in enumerate(procs):
            out, _ = p.communicate(timeout=120)
            text = out.decode(errors="replace")
            assert p.returncode == 0, f"worker {pid} failed:\n{text}"
            assert f"WORKER-OK {pid}" in text
    finally:
        for p in procs:              # exact-PID cleanup, never by pattern
            if p.poll() is None:
                p.kill()
                p.wait()
    assert all(p.poll() is not None for p in procs)

    for want in (single, jax):
        assert read(tmp_path / "mp.enc") == read(want)
        assert read(str(tmp_path / "mp.enc") + "_SIZE") == read(want + "_SIZE")
    assert read(tmp_path / "mp_dec.raw") == read(raw)


def test_scaling_report():
    rep = ScalingReport(frames=100, num_hosts=4,
                        host_wall_s=[2.5, 2.6, 2.4, 2.6],
                        single_host_wall_s=10.0)
    assert abs(rep.aggregate_fps - 100 / 2.6) < 1e-9
    assert abs(rep.efficiency - 10.0 / (4 * 2.6)) < 1e-9
    d = rep.as_dict()
    assert d["efficiency"] > 0.8
    assert ScalingReport(frames=1, num_hosts=1,
                         host_wall_s=[1.0]).efficiency is None


def _cpu_timed(fn):
    """The CPU time of `fn` (the process's, over all its threads): other
    processes on the machine lengthen a wall, not this."""
    t0 = time.process_time()
    fn()
    return time.process_time() - t0


def test_measured_scaling_efficiency_is_plausible(tmp_path):
    """Hosts run one after the other here, so the efficiency of measured
    encodes lands in (0, 1.05]: a superlinear number would mean a broken
    baseline. Each run is timed by the CPU time it takes, with torch on one
    thread, not by the wall, so that other processes on a shared machine
    (other test workers) cannot lengthen it by holding the CPU. The CPU's
    own speed still drifts between runs, so after a warm-up 10 turns of
    (single host, host 0, host 1) each give an efficiency, and their
    median is held to the bound."""
    rng = np.random.default_rng(2)
    n_frames = 2
    frames = [make_image(rng, 64, 64) for _ in range(n_frames)]
    raw = str(tmp_path / "v.raw")
    write_video(raw, frames)
    cfg = CodecConfig(width=64, height=64, wavelet_levels=1, frames=n_frames)
    luts = [neutral_lut(PARAMS, 1, 2)]
    single, merged = str(tmp_path / "single.enc"), str(tmp_path / "m.enc")
    hosts = 2
    runs = [lambda: encode_video(raw, single, cfg, luts, PARAMS,
                                 frames=n_frames, batch=1, device="cpu")]
    runs += [lambda h=h: encode_video_part(
        raw, merged, cfg, luts, PARAMS, frames=n_frames, num_hosts=hosts,
        host_id=h, batch=1, device="cpu") for h in range(hosts)]
    threads = torch.get_num_threads()
    torch.set_num_threads(1)        # no intra-op pool spinning on the CPU
    try:
        for run in runs:
            run()
        times = [[_cpu_timed(run) for run in runs] for _ in range(10)]
    finally:
        torch.set_num_threads(threads)
    merge_parts(merged, hosts)
    assert read(merged) == read(single)
    effs = [ScalingReport(frames=n_frames, num_hosts=hosts,
                          host_wall_s=walls,
                          single_host_wall_s=t_single).efficiency
            for t_single, *walls in times]
    assert all(e is not None and e > 0 for e in effs)
    eff = float(np.median(effs))
    assert 0 < eff <= 1.05, \
        f"implausible scaling efficiency {eff} ({effs}; {times})"
