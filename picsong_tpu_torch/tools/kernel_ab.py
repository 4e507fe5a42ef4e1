"""A/B device times of the BPC kernels of this tree against another
checkout's, on one card, in one process.

    python -m picsong_tpu_torch.tools.kernel_ab --other DIR [--sizes 2048,8192]
    python -m picsong_tpu_torch.tools.kernel_ab --other DIR --sweep
    python -m picsong_tpu_torch.tools.kernel_ab --other DIR --layers
    python -m picsong_tpu_torch.tools.kernel_ab [--other DIR] --split
    python -m picsong_tpu_torch.tools.kernel_ab --other DIR --pack
    python -m picsong_tpu_torch.tools.kernel_ab --other DIR --sharded
    python -m picsong_tpu_torch.tools.kernel_ab --other DIR --probes
    python -m picsong_tpu_torch.tools.kernel_ab --other DIR --sass

DIR is the root of another checkout (a `git archive` of the parent
commit, say); its package is imported under another name and launches
its own kernels through its own wrappers (built into
`DIR/build/picsong_tpu_torch`).
For each size (a gray 8-bit `goldens.make_image`, lossless 5/3, wl=5,
neutral LUT) and each mode (cp2, cp3, bulk with -k 5), both trees' encode
and decode kernels run on the same codeblocks, in turns (other, this,
this, other), each sample CUDA events around 20 back-to-back launches,
medians of 10; their outputs must be byte-equal. Prints the card, then one
JSON line per (size, mode, direction) with both trees' times, the bound
(`bpc_cuda.bound_ms`) and what bounds it.

`--sweep` instead times cp2 on one codeblock of the 2048^2 plane (the
largest magnitude outside the LL band) copied n times, n from 1 to 4224:
while the copies fit in one wave of resident CTAs, the time is one
block's dependency chain.

`--layers` instead times the layers around the BPC kernels, each tree's
own (the other tree's package imported under another name) on the same
2048^2 plane, in the same turns: prep + DWT + tiling and untile + inverse
DWT + clamp as the tree's codec runs them -- `transform/dwt_cuda.py`'s
`forward` / `reverse` where the tree has them (the X2/X4 kernels), else
`TorchCodec`'s torch-op methods -- (CUDA events around one call, as
chip_smoke.py's layers; sixteen turns of ten), lossless 5/3 wl=5 and lossy
9/7 wl=3 qs=1, and the same X2 layer's device time without the
wrapper's host time (`graph_ms`, a CUDA graph of 20 calls); for the
lossless one also the device encode and decode and the CLI round trip
(host clock with a synchronize, as chip_smoke.py's). Outputs must be
equal.

`--split` instead times X2 and X4 (`transform/dwt_cuda.py` `forward` and
`reverse`) level by level, for this tree and, with `--other`, the other
tree's in turns: the device time (`graph_ms`) at wl = 1 .. 5 on the same
planes, at the SPLIT_SHAPES (2048^2, the (8, 1088, 1920) video batch,
8192^2), each 5/3 and 9/7 qs 1; level 0 is the wl=1 time (for X4 with its
finish), level k the wl=k+1 time less the wl=k time. X4's codeblocks
come from the tree's `forward` at each wl, outside the graph. One JSON
line per (tree, kernel, shape, wavelet).

`--pack` instead times X3, the codestream pack and unpack
(`assembly/pack.py` `pack_streams` / `unpack_streams`), this tree's and
the other's, each through its own package (imported as for `--layers`),
in the same turns, on the streams K1 makes at the PACK_SHAPES (the main
path's 2048^2 plane, the 1080p video batch of 8 `goldens.make_frame`
frames, 8192^2; lossless 5/3 wl=5, neutral LUT, as chip_smoke.py makes
them), the payload given: the device time (`graph_ms`), the call time
over 20 back-to-back calls (CUDA events, medians of 10) and the bound
(`pack.bound_ms`); both trees' codestreams (with the header, and without
`payload=`) and unpacks must be byte-equal, and the unpack the streams
and sizes. One JSON line per (shape, direction). Then the wrapper split:
the host time of each part of one call of this tree's `pack_streams` and
`unpack_streams` at 2048^2 (checks, allocations, the device context, the
stream, the ctypes launch, the error check; each part run alone
`SPLIT_REPS` times back to back, median of 5), beside the whole call's
and the other tree's whole call; one JSON line per part.

`--sharded` instead times the row-sharded path (`dist/sharded.py`
`ShardedCodec`, every shard on the one card), this tree's and the
other's, each through its own package, in the LAYER_TURNS: the device
encode and decode (`encode_planes` / `decode_planes`, host clock with a
synchronize, ten a turn) of the 2048^2 wl=5 lossless main-path image
unsharded (`TorchCodec`) and on SHARDED_COUNTS shards of one card (and,
where several cards are visible, on as many cards as shards), and the
CLI round trip unsharded and with `-sharded 2`. Both trees' streams, sizes, decoded
samples and files must be byte-equal (and the decode bit-exact). One JSON
line per (shards, layer).

`--probes` instead times the probe kernels K3 and K4 (`tools/probe.py`
and `tools/probe2.py` `launch`), this tree's and the other's, each
through its own package, in the LAYER_TURNS, on the probes' own inputs:
the call time (CUDA events over PROBE_CALLS back-to-back launches,
medians of 10) and the device time (`graph_ms`), beside the same two
times of a one-element `add_` (the launch floor and the graph floor) and
the bound (`bound_ms`). Both trees' outputs must be byte-equal to each
other and to the plain version on the probes' inputs, seeds 1 and 2 and
the edge inputs. One JSON line for the floors and one per probe. Then
the wrapper split: the host time of each part of one `launch` (and of
`check_inputs`, which `run` adds), each part run alone SPLIT_REPS times
back to back, median of 5, beside both trees' whole `launch` (medians
over the LAYER_TURNS); one JSON line per part.

`--sass` instead compiles both trees' `csrc/dwt_forward.cu` and
`dwt_reverse.cu` to cubins (nvcc with the package's flags) and compares
the SASS of X2's and X4's whole-plane variants instruction by
instruction (`cuobjdump -sass`, addresses and encodings dropped): this
tree's variants with kShard false against the other tree's of the same
other template arguments. One JSON line per kernel: the variants, how
many are the same, and the first differing instruction of each other.
Then it dumps both trees' `probe_kernel` and `probe2_kernel` (`probe.cu`,
`probe2.cu`): a JSON line each with the counts of instructions, global
loads and stores, shuffles and branches, and whether a branch goes back
(a loop), then the instructions, one a line.
"""

from __future__ import annotations

import argparse
import contextlib
import importlib
import importlib.util
import io
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

BATCH = 20
ITERS = 10
SWEEP = (1, 33, 66, 132, 264, 528, 1056, 2112, 4224)
# the host's clock drifts within a run, so the layers take more turns
LAYER_TURNS = ("other", "this", "this", "other") * 4
# X2's per-level split: (label, height, width, frames (0: an image))
SPLIT_SHAPES = (("2048^2", 2048, 2048, 0), ("(8, 1088, 1920)", 1088, 1920, 8),
                ("8192^2", 8192, 8192, 0))
SPLIT_LEVELS = 5
# X3's shapes: (label, height, width, frames (0: an image))
PACK_SHAPES = (("2048^2", 2048, 2048, 0), ("(8, 1088, 1920)", 1080, 1920, 8),
               ("8192^2", 8192, 8192, 0))
SPLIT_REPS = 200
# back-to-back launches of a probe's call time (as chip_smoke.py's)
PROBE_CALLS = 200
# the row-sharded path's shard counts on one card (`--sharded`)
SHARDED_COUNTS = (2, 4)


def _times(fn, per: int = BATCH) -> list[float]:
    import torch
    fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(ITERS):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(per):
            fn()
        b.record()
        torch.cuda.synchronize()
        out.append(a.elapsed_time(b) / per)
    return out


def _host_times(fn) -> list[float]:
    """Host-clock times of `fn`, each between synchronisations of every
    visible card."""
    import torch

    def sync():
        for d in range(torch.cuda.device_count()):
            torch.cuda.synchronize(d)
    fn()
    out = []
    for _ in range(ITERS):
        sync()
        t = time.perf_counter()
        fn()
        sync()
        out.append((time.perf_counter() - t) * 1e3)
    return out


def graph_ms(fn, iters: int = 5, per: int = BATCH) -> float:
    """The device time a call of a kernel wrapper `fn`, without its host
    time: `per` calls captured in one CUDA graph, whose replay is timed
    with CUDA events (median over `iters`) and divided by `per`. `fn` must
    neither synchronise nor copy from the host. (Not torch.profiler: on an
    H100 it has recorded some of 20 back-to-back calls' kernels, or
    none.)"""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(per):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    out = []
    for _ in range(iters):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        graph.replay()
        b.record()
        torch.cuda.synchronize()
        out.append(a.elapsed_time(b) / per)
    del graph
    torch.cuda.empty_cache()
    return statistics.median(out)


def split_planes(h: int, w: int, frames: int, dev):
    """The gray 8-bit planes of a split shape: `goldens.make_image`, one a
    frame (seeds 11, 12, ... as chip_smoke.py's DWT phase)."""
    import numpy as np
    import torch

    from . import goldens
    planes = np.stack([goldens.make_image(h, seed=11 + k, width=w)
                       for k in range(max(frames, 1))])
    return torch.from_numpy(planes).to(dev).reshape(
        *((frames,) if frames else ()), h, w)


def level_split(dwt_cuda, plane, lossy: bool, reverse: bool = False,
                levels: int = SPLIT_LEVELS, config=None) -> list[float]:
    """X2's (or with `reverse` X4's) device time by level on one gray plane
    (or frame batch): `graph_ms` of the tree module `dwt_cuda`'s
    `forward([plane], cfg)` (or `reverse` of its codeblocks, made by
    `forward` outside the graph) at wl = 1 .. levels, then the differences
    (level 0 the wl=1 time). `config` is the tree's CodecConfig class
    (default this tree's)."""
    if config is None:
        from ..core.header import CodecConfig as config
    h, w = plane.shape[-2:]
    cum = []
    for wl in range(1, levels + 1):
        cfg = config(width=w, height=h, wavelet_levels=wl, is_lossy=lossy,
                     qs=1.0)
        if reverse:
            blocks = dwt_cuda.forward([plane], cfg)[0]
            cum.append(graph_ms(lambda: dwt_cuda.reverse(blocks, cfg)))
            del blocks
        else:
            cum.append(graph_ms(lambda: dwt_cuda.forward([plane], cfg)))
    return [cum[0]] + [b - a for a, b in zip(cum, cum[1:])]


def _split(other_root: str | None, card: str) -> int:
    """X2's and X4's per-level device time, this tree's and the other's in
    turns."""
    import torch

    pkgs = {"this": "picsong_tpu_torch"}
    if other_root:
        _other_package(other_root)
        pkgs["other"] = "ab_other"
    trees = {t: (importlib.import_module(f"{p}.transform.dwt_cuda"),
                 importlib.import_module(f"{p}.core.header").CodecConfig)
             for t, p in pkgs.items()}
    turns = ("other", "this", "this", "other") if other_root else ("this",)
    dev = torch.device("cuda")
    for label, h, w, frames in SPLIT_SHAPES:
        plane = split_planes(h, w, frames, dev)
        for kernel, reverse in (("X2", False), ("X4", True)):
            for lossy in (False, True):
                got = {t: [] for t in trees}
                for t in turns:
                    dwt_cuda, config = trees[t]
                    got[t].append(level_split(dwt_cuda, plane, lossy, reverse,
                                              config=config))
                for t, runs in got.items():
                    levels = [statistics.median(r[k] for r in runs)
                              for k in range(SPLIT_LEVELS)]
                    print(json.dumps({
                        "tree": t, "kernel": kernel, "shape": label,
                        "wavelet": "9/7 qs 1" if lossy else "5/3",
                        "levels_ms": levels, "total_ms": sum(levels),
                        "n": len(runs), "card": card}), flush=True)
        del plane
        torch.cuda.empty_cache()
    return 0


def _other_package(root: str):
    """The other checkout's picsong_tpu_torch, imported as `ab_other` (its
    imports within the package are relative)."""
    pkg = os.path.join(root, "picsong_tpu_torch")
    spec = importlib.util.spec_from_file_location(
        "ab_other", os.path.join(pkg, "__init__.py"),
        submodule_search_locations=[pkg])
    mod = importlib.util.module_from_spec(spec)
    sys.modules["ab_other"] = mod
    spec.loader.exec_module(mod)
    return mod


def _tree_layers(pkg: str, codec, samples):
    """(prep + DWT + tiling -> blocks, untile + IDWT + clamp of blocks ->
    samples) of a gray plane, as the tree `pkg`'s codec runs them."""
    try:
        dwt_cuda = importlib.import_module(f"{pkg}.transform.dwt_cuda")
    except ModuleNotFoundError:            # a tree from before X2/X4
        return (lambda: codec._dwt_tile_impl(
                    codec._prep_gray_impl(samples))[0],
                lambda b: codec._finish_gray_impl(
                    codec._untile_idwt_impl(b)))
    return (lambda: dwt_cuda.forward([samples], codec.cfg)[0][0],
            lambda b: dwt_cuda.reverse([b], codec.cfg)[0])


def _layers(other_root: str, card: str) -> int:
    """Both trees' torch-op layers on one 2048^2 plane, in turns."""
    import numpy as np
    import torch

    from ..core.image_io import write_pgm
    from ..engine import cli
    from . import goldens

    _other_package(other_root)
    trees = {t: {m: importlib.import_module(f"{pkg}.{m}")
                 for m in ("engine.pipeline", "engine.cli", "core.header")}
             for t, pkg in (("other", "ab_other"),
                            ("this", "picsong_tpu_torch"))}
    dev = torch.device("cuda")
    size = 2048
    img = goldens.make_image(size)
    samples = torch.from_numpy(img).to(dev)
    tmp = tempfile.TemporaryDirectory()
    src = os.path.join(tmp.name, "in.pgm")
    write_pgm(src, img)
    for name, kw in (("lossless 5/3 wl=5", dict(wavelet_levels=5)),
                     ("lossy 9/7 wl=3 qs=1", dict(wavelet_levels=3,
                                                  is_lossy=True, qs=1.0))):
        luts, params = cli._load_luts("neutral", kw["wavelet_levels"], 2, 0.0,
                                      lossy=kw.get("is_lossy", False))
        codecs = {t: m["engine.pipeline"].TorchCodec(
            m["core.header"].CodecConfig(width=size, height=size, **kw),
            luts, params, dev) for t, m in trees.items()}
        pkgs = {"other": "ab_other", "this": "picsong_tpu_torch"}
        fns = {t: _tree_layers(pkgs[t], c, samples)
               for t, c in codecs.items()}
        blocks = {t: fwd() for t, (fwd, _) in fns.items()}
        back = {t: rev(blocks[t]) for t, (_, rev) in fns.items()}
        if not (torch.equal(blocks["this"], blocks["other"])
                and torch.equal(back["this"], back["other"])):
            print(f"kernel_ab: {name}: the trees' layers disagree",
                  file=sys.stderr)
            return 1
        layers = {
            "prep+DWT+tile": lambda t: fns[t][0],
            "untile+IDWT+clamp": lambda t: (lambda: fns[t][1](
                blocks["this"])),
        }
        if not kw.get("is_lossy"):
            enc = os.path.join(tmp.name, "o.enc")
            dec = os.path.join(tmp.name, "d.pgm")
            streams, n_planes = codecs["this"].encode_planes([samples])
            coded = [(s, z, n_planes) for s, z in streams]

            def round_trip(t):
                main = trees[t]["engine.cli"].main

                def run():
                    with contextlib.redirect_stdout(io.StringIO()):
                        main(["-cd", "0", "-i", src, "-o", enc, "-wl", "5",
                              "-video", "0", "-LUTFolder", "neutral"])
                        main(["-cd", "1", "-i", enc, "-o", dec, "-video",
                              "0", "-LUTFolder", "neutral"])
                return run
            layers.update({
                "device encode": lambda t: (lambda: codecs[t].encode_planes(
                    [samples])),
                "device decode": lambda t: (lambda: codecs[t].decode_planes(
                    coded)),
            })
        for layer, make in layers.items():
            host = layer.startswith("device")
            samples_ms = in_turns({t: make(t) for t in fns}, {
                "ms": _host_times if host else (lambda fn: _times(fn, per=1))
            })["ms"]
            _print_ab(name, layer, "host clock" if host else "CUDA events",
                      samples_ms, card)
        # X2's device time a call, without the wrapper's host time
        samples_ms = in_turns({t: f[0] for t, f in fns.items()},
                              {"ms": lambda fn: [graph_ms(fn)]})["ms"]
        _print_ab(name, "prep+DWT+tile device", "CUDA graph", samples_ms,
                  card)
        if not kw.get("is_lossy"):
            samples_ms = in_turns({t: round_trip(t) for t in fns},
                                  {"ms": _host_times})["ms"]
            if not np.array_equal(np.fromfile(dec, np.uint8)[-img.size:],
                                  img.ravel()):
                print("kernel_ab: CLI round trip not bit-exact",
                      file=sys.stderr)
                return 1
            _print_ab(name, "CLI round trip", "host clock", samples_ms, card)
    tmp.cleanup()
    return 0


def pack_inputs(h: int, w: int, frames: int, dev):
    """K1's (streams, sizes) of a PACK_SHAPES entry, lossless 5/3 wl=5 with
    the neutral LUT: a gray `goldens.make_image` plane, or a batch of
    `frames` gray `goldens.make_frame` frames (seed 5, as chip_smoke.py's
    video phase) coded as one launch; and the image's header."""
    import numpy as np
    import torch

    from ..core.header import CodecConfig, pack_header
    from ..core.image_io import mirror_pad
    from ..engine import cli
    from ..engine.batch import BatchCodec
    from ..engine.pipeline import TorchCodec
    from ..entropy import bpc, bpc_cuda
    from ..transform import dwt_cuda
    from . import goldens

    cfg = CodecConfig(width=w, height=h, wavelet_levels=5)
    luts, params = cli._load_luts("neutral", 5, 2, 0.0)
    if frames:
        bc = BatchCodec(cfg, luts, params, frames, dev)
        planes = np.stack([mirror_pad(goldens.make_frame(h, w, j, 5), bc.aw,
                                      bc.ah) for j in range(frames)])
        blocks, mx = bc.prep_batch(torch.from_numpy(planes).to(dev))
        blocks, args, kw = blocks[0], bc._bpc_args(0), bc.codec._bpc_kw
    else:
        codec = TorchCodec(cfg, luts, params, dev)
        img = torch.from_numpy(goldens.make_image(h, width=w)).to(dev)
        (blocks,), mx = dwt_cuda.forward([img], cfg)
        args, kw = codec._bpc_args(), codec._bpc_kw
    streams, sizes = bpc_cuda.encode_blocks(
        blocks, *args, **kw, n_planes=bpc.planes_for_magnitude(int(mx)))
    return streams, sizes, pack_header(cfg)


def _host_us(fn, reps: int = SPLIT_REPS) -> float:
    """Host microseconds of one call of `fn`: `reps` calls back to back on
    the host clock, median of 5, the card drained between."""
    import torch
    fn()
    out = []
    for _ in range(5):
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(reps):
            fn()
        out.append((time.perf_counter() - t) / reps * 1e6)
    torch.cuda.synchronize()
    return statistics.median(out)


def in_turns(fns: dict, timers: dict, turns=LAYER_TURNS) -> dict:
    """Each timer's samples of each tree's callable, the trees timed in
    `turns` (the clocks drift within a run, so every tree is timed in every
    stretch of it): `fns` maps a tree to its callable, `timers` a name to a
    function from a callable to a list of samples. Returns {name: {tree:
    samples}}."""
    got = {name: {t: [] for t in fns} for name in timers}
    for t in turns:
        for name, timer in timers.items():
            got[name][t] += timer(fns[t])
    return got


# in_turns' timers of a kernel's device time and call time
DEVICE_AND_CALL = {"device": lambda fn: [graph_ms(fn)], "call": _times}


def _ab_medians(got: dict, bound: float, by: str) -> dict:
    """The JSON fields of `in_turns`' DEVICE_AND_CALL samples of both
    trees beside a bound: medians, the calls' minima and the shares of the
    bound."""
    dev = {t: statistics.median(v) for t, v in got["device"].items()}
    call = got["call"]
    return {"device_ms": dev["this"], "other_device_ms": dev["other"],
            "ms": statistics.median(call["this"]),
            "other_ms": statistics.median(call["other"]),
            "ms_min": min(call["this"]), "other_ms_min": min(call["other"]),
            "bound_ms": bound, "bound_by": by,
            "share_of_bound": bound / dev["this"],
            "other_share_of_bound": bound / dev["other"]}


def host_split(parts: dict, **fields) -> None:
    """The host time of each part of a call, `_host_us` of its callable
    (None: left out), one JSON line a part with `fields`."""
    for part, fn in parts.items():
        if fn is not None:
            print(json.dumps({**fields, "part": part, "us": _host_us(fn)}),
                  flush=True)


def _stream_parts(dev, on) -> dict:
    """The parts of a launch that find its device and stream: the device
    context and the Stream object's handle, and what the wrappers run in
    their place, `on` (`transform/dwt_cuda.py` `_on`)."""
    import torch

    def context():
        with torch.cuda.device(dev):
            pass

    def raw():
        ctx, stream = on(dev)
        with ctx:
            return stream

    return {
        "with torch.cuda.device(dev)": context,
        "torch.cuda.current_device()": torch.cuda.current_device,
        "torch.cuda.current_stream(dev).cuda_stream":
            lambda: torch.cuda.current_stream(dev).cuda_stream,
        "_on(dev) (context when not current, raw stream)": raw,
    }


def wrapper_split(pack, kernels, streams, sizes, header, card,
                  other=None) -> None:
    """The host time of each part of one `pack_streams` and one
    `unpack_streams` call of the tree module `pack` (payload given), each
    part as the wrapper runs it, and of the whole call (also of the other
    tree's module `other`'s, where given)."""
    import ctypes

    import numpy as np
    import torch

    lib, dev = kernels.library(), streams.device
    n = streams.shape[0]
    payload = int(sizes.sum()) - n
    code = pack.pack_streams(streams, sizes, header, payload=payload)
    out = torch.empty(pack.stream_length(n, payload), dtype=torch.int16,
                      device=dev)
    rows = torch.empty((n, 4096), dtype=torch.int32, device=dev)
    z = torch.empty(n, dtype=torch.int32, device=dev)
    status = torch.zeros(pack.status_words(n), dtype=torch.int64, device=dev)
    hdr = (ctypes.c_uint16 * pack.HEADER_SHORTS)(*header.tolist())
    stream = torch.cuda.current_stream(dev).cuda_stream

    def header_arg():
        h = np.ascontiguousarray(header, dtype=np.uint16)
        return (ctypes.c_uint16 * pack.HEADER_SHORTS)(*h.tolist())

    def unpack_checks():
        pack._check_payload(payload)
        return (code.dtype != torch.int16 or code.dim() != 1
                or not code.is_contiguous()
                or code.numel() < pack.stream_length(n, payload))

    common = {
        "torch.zeros (status)": lambda: torch.zeros(
            pack.status_words(n), dtype=torch.int64, device=dev),
        "torch.empty (status, for the zeroing's share)": lambda: torch.empty(
            pack.status_words(n), dtype=torch.int64, device=dev),
        **_stream_parts(dev, pack._on),
    }
    parts = {
        "pack": {
            "_check x2 + payload": lambda: (
                pack._check(streams, "streams", (n, 4096)),
                pack._check(sizes, "sizes", (n,)),
                pack._check_payload(payload)),
            "_device_type": lambda: pack._device_type([streams, sizes], "X3"),
            "_check_aligned": lambda: pack._check_aligned(streams, "streams"),
            "header to a ctypes array": header_arg,
            "torch.empty (codestream)": lambda: torch.empty(
                pack.stream_length(n, payload), dtype=torch.int16,
                device=dev),
            **common,
            "ctypes launch": lambda: lib.picsong_pack(
                streams.data_ptr(), sizes.data_ptr(), n,
                ctypes.addressof(hdr), payload, status.data_ptr(),
                out.data_ptr(), stream),
            "kernels.check": lambda: kernels.check(lib, 0, "pack launch"),
            "whole call": lambda: pack.pack_streams(streams, sizes, header,
                                                    payload=payload),
            "whole call, the other tree": other and (
                lambda: other.pack_streams(streams, sizes, header,
                                           payload=payload)),
        },
        "unpack": {
            "checks": unpack_checks,
            "_device_type": lambda: pack._device_type([code], "X3"),
            "torch.empty (rows)": lambda: torch.empty(
                (n, 4096), dtype=torch.int32, device=dev),
            "torch.empty (sizes)": lambda: torch.empty(
                n, dtype=torch.int32, device=dev),
            **common,
            "ctypes launch": lambda: lib.picsong_unpack(
                code.data_ptr(), n, payload, status.data_ptr(),
                rows.data_ptr(), z.data_ptr(), stream),
            "kernels.check": lambda: kernels.check(lib, 0, "unpack launch"),
            "whole call": lambda: pack.unpack_streams(code, n, payload),
            "whole call, the other tree": other and (
                lambda: other.unpack_streams(code, n, payload)),
        },
    }
    for d, fns in parts.items():
        host_split(fns, split=d, codeblocks=n, card=card)


def _pack(other_root: str, card: str) -> int:
    """Both trees' X3 at the PACK_SHAPES, in turns; then this tree's
    wrapper split."""
    import torch

    from .. import kernels
    from ..assembly import pack

    _other_package(other_root)
    packs = {"other": importlib.import_module("ab_other.assembly.pack"),
             "this": pack}
    dev = torch.device("cuda")
    for label, h, w, frames in PACK_SHAPES:
        streams, sizes, header = pack_inputs(h, w, frames, dev)
        n = streams.shape[0]
        payload = int(sizes.sum()) - n
        got = {t: m.pack_streams(streams, sizes, header)
               for t, m in packs.items()}
        code = got["this"]
        back = {t: m.unpack_streams(code, n, payload)
                for t, m in packs.items()}
        filler = {t: m.pack_streams(streams, sizes, None, payload=payload)
                  for t, m in packs.items()}
        if not (torch.equal(got["this"], got["other"])
                and torch.equal(filler["this"], filler["other"])
                and all(torch.equal(a, b) for a, b in zip(back["this"],
                                                          back["other"]))
                and torch.equal(back["this"][0], streams)
                and torch.equal(back["this"][1], sizes)):
            print(f"kernel_ab: X3 at {label}: the trees disagree",
                  file=sys.stderr)
            return 1
        bound = pack.bound_ms(n, payload)
        for d in ("pack", "unpack"):
            def run(m, d=d):
                if d == "pack":
                    return lambda: m.pack_streams(streams, sizes, header,
                                                  payload=payload)
                return lambda: m.unpack_streams(code, n, payload)
            got = in_turns({t: run(m) for t, m in packs.items()},
                           DEVICE_AND_CALL, ("other", "this", "this",
                                             "other"))
            print(json.dumps({
                "shape": label, "codeblocks": n, "payload": payload,
                "kernel": d, **_ab_medians(got, *bound[d]),
                "card": card}), flush=True)
        if label == PACK_SHAPES[0][0]:
            split_inputs = (streams, sizes, header)
        del streams, sizes, got, code, back, filler
        torch.cuda.empty_cache()
    wrapper_split(pack, kernels, *split_inputs, card, packs["other"])
    return 0


def probe_cases(module) -> tuple:
    """(label, numpy arguments) of a probe module's checked inputs: its own
    (seed 0), seeds 1 and 2 and its edge inputs."""
    return (("probe inputs", module.inputs(0)), ("seed 1", module.inputs(1)),
            ("seed 2", module.inputs(2)), ("edge inputs", module.edge_inputs()))


def probe_split(name: str, module, kernels, dargs, card, other) -> None:
    """The host time of each part of one `launch` of the tree module
    `module` (`tools/probe.py` or `probe2.py`, `name` its C entry point's
    suffix) on its CUDA arguments `dargs`, each part as the wrapper runs
    it, beside `check_inputs` and `run` (which adds it); then the whole
    `launch` of it and of the other tree's module `other` in the
    LAYER_TURNS."""
    import torch

    from ..transform import dwt_cuda

    lib, dev = kernels.library(), dargs[0].device
    out = torch.empty((module.ROWS, module.C), dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    entry = getattr(lib, f"picsong_{name}")
    host_split({
        "check_inputs (run's, outside launch; reads the device)":
            lambda: module.check_inputs(*dargs),
        "kernels.library()": kernels.library,
        "torch.empty (out)": lambda: torch.empty(
            (module.ROWS, module.C), dtype=torch.int32, device=dev),
        **_stream_parts(dev, dwt_cuda._on),
        "ctypes launch": lambda: entry(dargs[0].data_ptr(),
                                       dargs[1].data_ptr(), out.data_ptr(),
                                       stream),
        "kernels.check": lambda: kernels.check(lib, 0, f"{name} launch"),
        "whole run": lambda: module.run(*dargs),
    }, split=name, card=card)
    # the whole launch of both trees in turns: the host's spread is as
    # large as the parts
    us = in_turns({t: (lambda m=m: m.launch(*dargs))
                   for t, m in (("this", module), ("other", other))},
                  {"us": lambda fn: [_host_us(fn)]})["us"]
    for t, samples in us.items():
        print(json.dumps({"split": name, "part": "whole launch" + (
            ", the other tree" if t == "other" else ""),
            "us": statistics.median(samples), "us_min": min(samples),
            "n": len(samples), "card": card}), flush=True)


def _probes(other_root: str, card: str) -> int:
    """Both trees' probe kernels at the probes' own inputs, in turns,
    beside the floors; then this tree's wrapper split."""
    import torch

    from .. import kernels
    from . import probe, probe2

    _other_package(other_root)
    dev = torch.device("cuda")
    one = torch.zeros(1, dtype=torch.int32, device=dev)
    floor = {"launch_floor_ms": statistics.median(_times(
                 lambda: one.add_(1), per=PROBE_CALLS)),
             "graph_floor_ms": graph_ms(lambda: one.add_(1))}
    print(json.dumps({"floor": "one-element add_", **floor, "card": card}),
          flush=True)
    timers = {"device": lambda fn: [graph_ms(fn)],
              "call": lambda fn: _times(fn, per=PROBE_CALLS)}
    for name, module in (("probe", probe), ("probe2", probe2)):
        mods = {"other": importlib.import_module(f"ab_other.tools.{name}"),
                "this": module}
        for label, args in probe_cases(module):
            dargs = [torch.from_numpy(a).to(dev) for a in args]
            got = {t: m.launch(*dargs) for t, m in mods.items()}
            if not (torch.equal(got["this"], got["other"])
                    and torch.equal(got["this"], module.plain(*dargs))):
                print(f"kernel_ab: {name} ({label}): the trees or the plain "
                      "version disagree", file=sys.stderr)
                return 1
        dargs = [torch.from_numpy(a).to(dev) for a in module.inputs(0)]
        got = in_turns({t: (lambda m=m: m.launch(*dargs))
                        for t, m in mods.items()}, timers)
        print(json.dumps({
            "kernel": name, **_ab_medians(got, *module.bound_ms(*dargs)),
            **floor, "n": len(got["device"]["this"]), "card": card}),
            flush=True)
    for name, module in (("probe", probe), ("probe2", probe2)):
        dargs = [torch.from_numpy(a).to(dev) for a in module.inputs(0)]
        probe_split(name, module, kernels, dargs, card,
                    importlib.import_module(f"ab_other.tools.{name}"))
    return 0


def _sharded(other_root: str, card: str) -> int:
    """Both trees' row-sharded device encode / decode and CLI round trips
    at 2048^2 wl=5 lossless, unsharded and sharded, in turns."""
    import numpy as np
    import torch

    from ..core.image_io import write_pgm
    from ..engine import cli
    from . import goldens

    _other_package(other_root)
    trees = {t: {m: importlib.import_module(f"{pkg}.{m}")
                 for m in ("dist.sharded", "engine.pipeline", "engine.cli",
                           "core.header")}
             for t, pkg in (("other", "ab_other"),
                            ("this", "picsong_tpu_torch"))}
    dev = torch.device("cuda")
    size = 2048
    img = goldens.make_image(size)
    luts, params = cli._load_luts("neutral", 5, 2, 0.0)
    tmp = tempfile.TemporaryDirectory()
    src = os.path.join(tmp.name, "in.pgm")
    write_pgm(src, img)

    def same(a, b) -> bool:
        if isinstance(a, torch.Tensor):
            return torch.equal(a, b)
        if isinstance(a, (list, tuple)):
            return len(a) == len(b) and all(same(x, y) for x, y in zip(a, b))
        return a == b

    cards = torch.cuda.device_count()
    configs = [(n, [dev] * n) for n in (1, *SHARDED_COUNTS)]
    configs += [(n, [torch.device("cuda", d) for d in range(n)])
                for n in SHARDED_COUNTS if n <= cards]
    for n, devices in configs:
        name = f"{size}^2 wl=5 lossless, " + (
            f"{n} shards on {len(set(devices))} card(s)" if n > 1
            else "unsharded")
        fns, outs = {}, {}
        for t, m in trees.items():
            cfg = m["core.header"].CodecConfig(width=size, height=size,
                                               wavelet_levels=5)
            if n == 1:
                codec = m["engine.pipeline"].TorchCodec(cfg, luts, params,
                                                        dev)
                up = [torch.from_numpy(img).to(dev)]
                coded, n_planes = codec.encode_planes(up)
                dc = [(s_, z_, n_planes) for s_, z_ in coded]
            else:
                codec = m["dist.sharded"].ShardedCodec(cfg, luts, params,
                                                       devices)
                up = codec.upload(img)
                coded, n_planes = codec.encode_planes(up)
                dc = [(shards, n_planes) for shards in coded]
            outs[t] = (coded, n_planes, codec.decode_planes(dc))
            fns[t] = {"device encode": (lambda c=codec, u=up:
                                        c.encode_planes(u)),
                      "device decode": (lambda c=codec, d=dc:
                                        c.decode_planes(d))}
        if not same(outs["this"], outs["other"]):
            print(f"kernel_ab: {name}: the trees disagree", file=sys.stderr)
            return 1
        for layer in ("device encode", "device decode"):
            samples_ms = in_turns({t: f[layer] for t, f in fns.items()},
                                  {"ms": _host_times})["ms"]
            _print_ab(name, layer, "host clock", samples_ms, card)
        del fns, outs
        torch.cuda.empty_cache()
    for n in (1, 2):
        shard = ["-sharded", str(n)] if n > 1 else []
        files = {t: (os.path.join(tmp.name, f"{t}{n}.enc"),
                     os.path.join(tmp.name, f"{t}{n}.pgm")) for t in trees}

        def round_trip(t, shard=shard, files=files):
            main = trees[t]["engine.cli"].main
            enc, dec = files[t]

            def run():
                with contextlib.redirect_stdout(io.StringIO()):
                    main(["-cd", "0", "-i", src, "-o", enc, "-wl", "5",
                          "-LUTFolder", "neutral", *shard])
                    main(["-cd", "1", "-i", enc, "-o", dec, "-LUTFolder",
                          "neutral", *shard])
            return run
        samples_ms = in_turns({t: round_trip(t) for t in trees},
                              {"ms": _host_times})["ms"]
        got = {}
        for t, (enc, dec) in files.items():
            got[t] = []
            for f in (enc, enc + "_SIZE", dec):
                with open(f, "rb") as fh:
                    got[t].append(fh.read())
        if got["this"] != got["other"] or not np.array_equal(
                np.frombuffer(got["this"][2], np.uint8)[-img.size:],
                img.ravel()):
            print(f"kernel_ab: CLI -sharded {n}: the trees' files differ or "
                  "the round trip is not bit-exact", file=sys.stderr)
            return 1
        _print_ab(f"{size}^2 wl=5 lossless"
                  + (f", -sharded {n}" if n > 1 else ""),
                  "CLI round trip", "host clock", samples_ms, card)
    tmp.cleanup()
    return 0


def _sass_of(cubin: str, cuobjdump: str, addresses: bool = False) -> dict:
    """A cubin's kernels by their demangled names -> their SASS
    instructions (text without the encoding comments; with `addresses`,
    (address, text) pairs, else the text alone)."""
    text = subprocess.run([cuobjdump, "-sass", cubin], capture_output=True,
                          text=True, check=True).stdout
    out, cur = {}, None
    for line in text.splitlines():
        if "Function : " in line:
            name = subprocess.run(
                ["c++filt", line.split("Function : ")[1].strip()],
                capture_output=True, text=True, check=True).stdout.strip()
            cur = out.setdefault(name, [])
        elif cur is not None and line.strip().startswith("/*") and \
                ";" in line:
            where, rest = line.strip()[2:].split("*/", 1)
            code = " ".join(rest.split(";")[0].split())
            cur.append((int(where, 16), code) if addresses else code)
    return out


def _template_args(name: str) -> tuple:
    return tuple(a.strip() for a in
                 name[name.index("<") + 1:name.index(">")].split(","))


def sass_summary(code: list) -> dict:
    """Counts of one kernel's (address, instruction) list: instructions,
    global loads and stores, shuffles, branches, and whether a branch goes
    back to an earlier address (a loop; the branch to itself that ends
    every kernel is not one)."""
    ops = [c.split()[0] if not c.startswith("@") else c.split()[1]
           for _, c in code]

    def count(prefix):
        return sum(op.startswith(prefix) for op in ops)

    back = any(op == "BRA" and int(c.split("0x")[-1].split()[0], 16) < at
               for (at, c), op in zip(code, ops) if "0x" in c)
    return {"instructions": len(code), "global_loads": count("LDG"),
            "global_stores": count("STG"), "shuffles": count("SHFL"),
            "branches": count("BRA"), "loops": back}


def _sass(other_root: str) -> int:
    """X2's and X4's whole-plane variants, this tree's against the other's
    compiled from the same flags; then both trees' probe kernels."""
    from .. import kernels

    nvcc = kernels.find_nvcc()
    cuobjdump = os.path.join(os.path.dirname(nvcc), "cuobjdump")
    flags = [f for f in kernels.NVCC_FLAGS
             if f not in ("-Xcompiler", "-fPIC", "-Xptxas=-v")]
    trees = {"this": kernels.CSRC_DIR,
             "other": os.path.join(other_root, "picsong_tpu_torch", "csrc")}
    tmp = tempfile.TemporaryDirectory()

    def compiled(t: str, source: str, addresses: bool = False) -> dict:
        cubin = os.path.join(tmp.name, f"{t}_{source}.cubin")
        subprocess.run([nvcc, *flags, "-cubin", "-o", cubin,
                        os.path.join(trees[t], f"{source}.cu")],
                       check=True, capture_output=True)
        return _sass_of(cubin, cuobjdump, addresses)

    for name in ("forward", "reverse"):
        sass = {t: {_template_args(k): v
                    for k, v in compiled(t, f"dwt_{name}").items()}
                for t in trees}
        same, differing = 0, []
        for args, code in sorted(sass["this"].items()):
            if args[-1] != "false":
                continue                    # a shard-mode variant
            want = sass["other"].get(args, sass["other"].get(args[:-1]))
            if want == code:
                same += 1
                continue
            first = next((i for i, (a, b) in enumerate(zip(code, want or []))
                          if a != b), min(len(code), len(want or [])))
            differing.append({"variant": list(args), "first": first,
                              "this": code[first:first + 1],
                              "other": (want or [])[first:first + 1]})
        print(json.dumps({"kernel": f"dwt_{name}", "whole_plane_variants":
                          same + len(differing), "same_sass": same,
                          "differing": differing}), flush=True)
    dumps = []
    for source in ("probe", "probe2"):
        for t in trees:
            for fn, code in compiled(t, source, addresses=True).items():
                print(json.dumps({"tree": t, "kernel": fn,
                                  **sass_summary(code)}), flush=True)
                dumps += [f"{t} {source} {at:04x} {c}" for at, c in code]
    print("\n".join(dumps), flush=True)
    tmp.cleanup()
    return 0


def _print_ab(config, layer, clock, samples, card) -> None:
    print(json.dumps({
        "config": config, "layer": layer, "clock": clock,
        "ms": statistics.median(samples["this"]),
        "other_ms": statistics.median(samples["other"]),
        "ms_min": min(samples["this"]),
        "other_ms_min": min(samples["other"]), "n": len(samples["this"]),
        "card": card}), flush=True)


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--other")
    ap.add_argument("--sizes", default="2048,8192")
    ap.add_argument("--sweep", action="store_true")
    ap.add_argument("--layers", action="store_true")
    ap.add_argument("--split", action="store_true")
    ap.add_argument("--pack", action="store_true")
    ap.add_argument("--sharded", action="store_true")
    ap.add_argument("--probes", action="store_true")
    ap.add_argument("--sass", action="store_true")
    args = ap.parse_args(argv)
    if not (args.split or args.other):
        ap.error("--other is required unless --split")

    import torch

    from ..core.geometry import codeblock_bands
    from ..core.header import CodecConfig
    from ..engine import cli
    from ..engine.pipeline import TorchCodec
    from ..entropy import bpc, bpc_cuda
    from ..transform import dwt_cuda
    from . import goldens

    if not torch.cuda.is_available():
        print("kernel_ab: no CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.splitlines()[0]
    print(card)
    if args.split:
        return _split(args.other and os.path.abspath(args.other), card)
    if args.layers:
        return _layers(os.path.abspath(args.other), card)
    if args.pack:
        return _pack(os.path.abspath(args.other), card)
    if args.sharded:
        return _sharded(os.path.abspath(args.other), card)
    if args.probes:
        return _probes(os.path.abspath(args.other), card)
    if args.sass:
        return _sass(os.path.abspath(args.other))
    _other_package(os.path.abspath(args.other))
    # each tree's own wrapper, which builds and binds its own kernels
    coders = {"other": importlib.import_module("ab_other.entropy.bpc_cuda"),
              "this": bpc_cuda}
    dev = torch.device("cuda")
    if args.sweep:
        cfg = CodecConfig(width=2048, height=2048, wavelet_levels=5)
        luts, params = cli._load_luts("neutral", 5, 2, 0.0)
        c = TorchCodec(cfg, luts, params, dev)
        img = torch.from_numpy(goldens.make_image(2048)).to(dev)
        (blocks,), mx = dwt_cuda.forward([img], cfg)
        kw = dict(c._bpc_kw, n_planes=bpc.planes_for_magnitude(int(mx)))
        mag = blocks.reshape(blocks.shape[0], -1).abs().amax(dim=1)
        level = torch.as_tensor(codeblock_bands(c.aw, c.ah, 5)[0], device=dev)
        i = int(torch.argmax(torch.where(level != 5, mag, -1)))
        for n in SWEEP:
            b = blocks[i:i + 1].expand(n, 64, 64).contiguous()
            a = (c._bpc_args()[0],
                 *(m[i:i + 1].expand(n).contiguous() for m in c._meta))
            row = {"n": n, "block": i, "magnitude": int(mag[i])}
            for t, coder in coders.items():
                s, z = coder.encode_blocks(b, *a, **kw)
                row[f"{t}_encode_ms"] = statistics.median(_times(
                    lambda: coder.encode_blocks(b, *a, **kw)))
                row[f"{t}_decode_ms"] = statistics.median(_times(
                    lambda: coder.decode_blocks(s, z, *a, **kw)))
            row["size"] = int(z[0])
            print(json.dumps(row), flush=True)
        return 0
    for size in (int(s) for s in args.sizes.split(",")):
        img = torch.from_numpy(goldens.make_image(size)).to(dev)
        for mode, cp, k in (("cp2", 2, 0.0), ("cp3", 3, 0.0),
                            ("bulk", 2, 5.0)):
            cfg = CodecConfig(width=size, height=size, wavelet_levels=5,
                              coding_passes=cp, k_factor=k)
            luts, params = cli._load_luts("neutral", 5, cp, k)
            c = TorchCodec(cfg, luts, params, dev)
            (blocks,), mx = dwt_cuda.forward([img], cfg)
            n_planes = bpc.planes_for_magnitude(int(mx))
            a, kw = c._bpc_args(), dict(c._bpc_kw, n_planes=n_planes)
            enc = {t: coder.encode_blocks(blocks, *a, **kw)
                   for t, coder in coders.items()}
            streams, sizes = enc["this"]
            dec = {t: coder.decode_blocks(streams, sizes, *a, **kw)
                   for t, coder in coders.items()}
            torch.cuda.synchronize()
            if not (torch.equal(enc["this"][0], enc["other"][0])
                    and torch.equal(enc["this"][1], enc["other"][1])
                    and torch.equal(dec["this"], dec["other"])
                    and torch.equal(dec["this"], blocks)):
                print(f"kernel_ab: {size}^2 {mode}: the trees disagree",
                      file=sys.stderr)
                return 1
            bound, by = bpc_cuda.bound_ms(blocks)
            for d in ("encode", "decode"):
                def run(coder):
                    if d == "encode":
                        return lambda: coder.encode_blocks(blocks, *a, **kw)
                    return lambda: coder.decode_blocks(streams, sizes, *a,
                                                       **kw)
                samples = in_turns({t: run(c) for t, c in coders.items()},
                                   {"ms": _times}, ("other", "this", "this",
                                                    "other"))["ms"]
                ms = {t: statistics.median(v) for t, v in samples.items()}
                print(json.dumps({
                    "size": size, "blocks": blocks.shape[0], "mode": mode,
                    "kernel": d, "n_planes": n_planes, "ms": ms["this"],
                    "other_ms": ms["other"], "ms_min": min(samples["this"]),
                    "other_ms_min": min(samples["other"]),
                    "bound_ms": bound, "bound_by": by,
                    "share_of_bound": bound / ms["this"], "card": card}),
                    flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
