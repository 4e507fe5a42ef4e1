"""Run one cell of the port's benchmark once.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

From the root of a checkout. The cell (BENCHMARK.json) names a
configuration (its file, and the LUT folder beside it) and a traffic mix
(`traffic/<name>.json`, whose entry into the program is
`entries/<name>.py`; a request codes the mix's `frames_per_request` pool
images, one when it names none). Set-up makes the image pool from the seed
on the card, builds the program's codec, and warms every shape the mix
uses; then a closed loop runs for the window; then the plain reference
codes the pool and the sampled frames are compared with it. `--trace 0`
prints the cell's end-to-end metrics, `--trace 1` its per-layer metrics
from a `torch.profiler` trace of the window (`metrics/<name>.py`). The
last line of standard output is the result's JSON object; the numbers
compared, each beside its limit, end standard error.

`--device cpu` skips the look for a card and runs the program's plain
PyTorch versions; the tests use it at tiny sizes, and `--bench` names
another benchmark file for them. `--system control` puts the control
(`harness/control.py`) in the program's place.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))
# every build and kernel cache inside the checkout, at fixed paths
for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("TRITON_CACHE_DIR", "triton"), ("CUDA_CACHE_PATH", "nv")):
    os.environ[var] = str(ROOT / "build" / "bench_cache" / sub)

FOREIGN = ("jax", "jaxlib", "flax", "picsong_tpu")


def _args(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    p.add_argument("--bench", type=Path, default=ROOT / "BENCHMARK.json")
    p.add_argument("--system", choices=("program", "control"),
                   default="program")
    return p.parse_args(argv)


def _power_limit():
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits", "-i", "0"],
            capture_output=True, text=True, timeout=30, check=True)
        return float(out.stdout.split()[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return None


def _foreign_modules() -> list[str]:
    return sorted(m for m in sys.modules if m.split(".")[0] in FOREIGN)


def _sample_dtype(cfg, torch):
    if cfg.bps <= 8:
        return torch.int8 if cfg.is_signed else torch.uint8
    return torch.int32


def _mirror_pad(plane, height: int, width: int, torch):
    """Right and bottom padding by reflection, the edge sample repeated."""
    h, w = plane.shape
    if width > w:
        plane = torch.cat([plane, plane[:, 2 * w - width:].flip(1)], 1)
    if height > h:
        plane = torch.cat([plane, plane[2 * h - height:].flip(0)], 0)
    return plane


def main(argv=None) -> int:
    args = _args(argv)
    import numpy as np
    import torch

    from benchmark.harness import cells

    cell = cells.load_cell(args.workload, args.bench)
    if args.device == "cuda" and (
            not torch.cuda.is_available()
            or torch.cuda.device_count() < cell.chips):
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"{cell.name} needs {cell.chips} CUDA device(s); "
              f"{have} available", file=sys.stderr)
        return 3
    device = torch.device("cuda:0" if args.device == "cuda" else "cpu")

    from benchmark.harness import images, judge, loop, readers, system, trace
    from benchmark.reference import codec as reference
    from benchmark.reference.lut import load_luts

    fields = {f: cell.config[f] for f in
              reference.Config.__dataclass_fields__ if f in cell.config}
    cfg = reference.Config(**fields)
    if cfg.coding_passes != 2 or cfg.k_factor != 0 or (cfg.is_rgb
                                                       and cfg.is_lossy):
        raise NotImplementedError(
            "the reference codes two passes, k = 0, and RGB lossless only")
    luts, params = load_luts(str(cell.config_dir / cell.config["lut_folder"]),
                             cfg.wavelet_levels)
    traffic = cell.traffic
    frames = traffic.get("frames_per_request", 1)
    if not isinstance(frames, int) or frames < 1:
        raise ValueError(f"frames_per_request must be a whole number from "
                         f"1 up, not {frames!r}")
    ah, aw = cfg.padded
    sample_bytes = 1 if cfg.bps <= 8 else 2
    n_images = images.pool_size(cfg.width * cfg.height * sample_bytes,
                                cfg.n_planes_in, traffic["pool"])
    pool = images.make_pool(args.seed, n_images, cfg.n_planes_in, cfg.height,
                            cfg.width, (1 << cfg.bit_depth) - 1,
                            traffic["content"], device)
    padded = [[_mirror_pad(p, ah, aw, torch) for p in image]
              for image in pool]
    if args.system == "control":
        from benchmark.harness.control import ControlEntry
        entry = ControlEntry(cfg, luts, params, device, padded,
                             _sample_dtype(cfg, torch))
    else:
        entry = system.entry(traffic["entry"], cell.config, luts, params,
                             device, system.Inputs(pool, padded,
                                                   reference.header(cfg)))
    reservoir = loop.Reservoir(traffic["keep"], args.seed)
    warm_failed = loop.warm_up(entry, n_images, frames, reservoir, device)
    setup_s = time.perf_counter() - T0

    before = system.counters()
    if args.trace:
        from torch.profiler import ProfilerActivity, profile
        activities = [ProfilerActivity.CPU]
        if device.type == "cuda":
            activities.append(ProfilerActivity.CUDA)
        with profile(activities=activities) as prof:
            window = loop.run(entry, n_images, frames, args.seconds,
                              reservoir, device)
        tr = trace.read(prof)
        del prof
    else:
        window = loop.run(entry, n_images, frames, args.seconds,
                          reservoir, device)
    after = system.counters()
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)

    kept = [(i, image, entry.to_host(parts))
            for i, image, parts in reservoir.outputs()]
    del entry, pool, reservoir
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()

    expected = reference.ReferenceCodec(cfg, luts, params, device).run(
        padded, _sample_dtype(cfg, torch))
    if not cfg.is_lossy:
        for image, coded in zip(padded, expected):
            inputs = [p[:cfg.height, :cfg.width].cpu().numpy() for p in image]
            if not all(np.array_equal(a, b)
                       for a, b in zip(inputs, coded.decoded)):
                raise RuntimeError("the reference does not decode its own "
                                   "lossless codestream to its input")
    numbers, differing = judge.compare(kept, expected)
    failed = warm_failed + window.failed
    correct = judge.verdict(numbers) and failed == 0 and len(kept) > 0

    n = len(window.encode_s)
    lines = []
    if args.trace:
        run = readers.Run(tr, {k: after[k] - before[k] for k in after},
                          expected, cfg, n_images, frames)
        metrics = {}
        for spec in cell.per_layer:
            try:
                value = cells.by_name(ROOT / "benchmark" / "metrics",
                                      spec["name"]).read(run)
            except readers.MissingSpans as e:
                print(f"no trace of a launched kernel: {e}", file=sys.stderr)
                return 5
            if value is not None:
                metrics[spec["name"]] = {"value": value, "unit": spec["unit"]}
        lines = run.notes
        lo, hi = tr.window
        busy = trace.union_ns((s, e) for _, s, e in tr.spans)
    else:
        mpix = window.frames * cfg.width * cfg.height / 1e6
        values = {
            "mpix_s": mpix / window.seconds if window.seconds else 0.0,
            "encode_p95_ms": float(np.percentile(window.encode_s, 95)) * 1e3
            if n else 0.0,
            "decode_p95_ms": float(np.percentile(window.decode_s, 95)) * 1e3
            if n else 0.0,
            "setup_s": setup_s}
        metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
                   for m in cell.end_to_end}

    dev = {"platform": "gpu" if device.type == "cuda" else "cpu",
           "kind": (torch.cuda.get_device_name(device)
                    if device.type == "cuda" else "cpu"),
           "count": 1, "memory_peak_bytes": int(peak)}
    if device.type == "cuda":
        dev["power_limit_w"] = _power_limit()
    if args.trace:
        dev["busy_s"] = busy / 1e9
        dev["window_s"] = (hi - lo) / 1e9

    foreign = _foreign_modules()
    if foreign:
        print(f"JAX or the JAX package is loaded: {foreign}", file=sys.stderr)
        return 4

    checks = {k: {"value": v, "limit": judge.LIMITS[k]}
              for k, v in numbers.items()}
    result = {"correct": bool(correct),
              "attempted": warm_failed + window.attempted,
              "failed": failed + differing, "metrics": metrics,
              "device": dev}
    if args.trace:
        result["breakdown"] = trace.breakdown(tr)
    result["checks"] = checks
    for line in lines:
        print(line)
    words = sum(int(w.sum()) for coded in expected for w in coded.words)
    print(f"{cell.name}: {n} requests of {frames} frame(s) in "
          f"{window.seconds:.3f} s, {len(kept)} frames compared, set-up "
          f"{setup_s:.3f} s; the pool's "
          f"{n_images} images code to {words} words")
    for what, lat in (("encode", window.encode_s),
                      ("decode", window.decode_s)):
        if lat:
            q = np.percentile(lat, [50, 90, 95, 99, 100]) * 1e3
            print(f"{what} ms p50 {q[0]:.3f} p90 {q[1]:.3f} p95 {q[2]:.3f} "
                  f"p99 {q[3]:.3f} max {q[4]:.3f}")
    sys.stdout.flush()
    for k, v in checks.items():
        print(f"check {k} = {v['value']} (limit {v['limit']})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
