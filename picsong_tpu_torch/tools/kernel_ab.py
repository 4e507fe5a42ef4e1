"""A/B device times of the BPC kernels of this tree against another
checkout's, on one card, in one process.

    python -m picsong_tpu_torch.tools.kernel_ab --other DIR [--sizes 2048,8192]
    python -m picsong_tpu_torch.tools.kernel_ab --other DIR --sweep

DIR is the root of another checkout (a `git archive` of the parent
commit, say); its `picsong_tpu_torch/csrc` is built into `DIR/build/ab`.
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
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys

BATCH = 20
ITERS = 10
SWEEP = (1, 33, 66, 132, 264, 528, 1056, 2112, 4224)


def _times(fn) -> list[float]:
    import torch
    fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(ITERS):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(BATCH):
            fn()
        b.record()
        torch.cuda.synchronize()
        out.append(a.elapsed_time(b) / BATCH)
    return out


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--other", required=True)
    ap.add_argument("--sizes", default="2048,8192")
    ap.add_argument("--sweep", action="store_true")
    args = ap.parse_args(argv)

    import torch

    from .. import kernels
    from ..core.geometry import codeblock_bands
    from ..core.header import CodecConfig
    from ..engine import cli
    from ..engine.pipeline import TorchCodec
    from ..entropy import bpc, bpc_cuda
    from . import goldens

    if not torch.cuda.is_available():
        print("kernel_ab: no CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.splitlines()[0]
    print(card)
    other_dir = os.path.join(os.path.abspath(args.other), "build", "ab")
    other_lib, _ = kernels.build(
        build_dir=other_dir,
        csrc_dir=os.path.join(os.path.abspath(args.other),
                              "picsong_tpu_torch", "csrc"))
    libs = {"other": kernels.load(other_lib), "this": kernels.library()}
    dev = torch.device("cuda")
    if args.sweep:
        cfg = CodecConfig(width=2048, height=2048, wavelet_levels=5)
        luts, params = cli._load_luts("neutral", 5, 2, 0.0)
        c = TorchCodec(cfg, luts, params, dev)
        img = torch.from_numpy(goldens.make_image(2048)).to(dev)
        blocks, mx = c._dwt_tile_impl(c._prep_gray_impl(img))
        kw = dict(c._bpc_kw, n_planes=bpc.planes_for_magnitude(int(mx)))
        mag = blocks.reshape(blocks.shape[0], -1).abs().amax(dim=1)
        level = torch.as_tensor(codeblock_bands(c.aw, c.ah, 5)[0], device=dev)
        i = int(torch.argmax(torch.where(level != 5, mag, -1)))
        for n in SWEEP:
            b = blocks[i:i + 1].expand(n, 64, 64).contiguous()
            a = (c._bpc_args()[0],
                 *(m[i:i + 1].expand(n).contiguous() for m in c._meta))
            row = {"n": n, "block": i, "magnitude": int(mag[i])}
            for t, lib in libs.items():
                s, z = bpc_cuda.encode_blocks(b, *a, **kw, lib=lib)
                row[f"{t}_encode_ms"] = statistics.median(_times(
                    lambda: bpc_cuda.encode_blocks(b, *a, **kw, lib=lib)))
                row[f"{t}_decode_ms"] = statistics.median(_times(
                    lambda: bpc_cuda.decode_blocks(s, z, *a, **kw, lib=lib)))
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
            blocks, mx = c._dwt_tile_impl(c._prep_gray_impl(img))
            n_planes = bpc.planes_for_magnitude(int(mx))
            a, kw = c._bpc_args(), dict(c._bpc_kw, n_planes=n_planes)
            enc = {t: bpc_cuda.encode_blocks(blocks, *a, **kw, lib=lib)
                   for t, lib in libs.items()}
            streams, sizes = enc["this"]
            dec = {t: bpc_cuda.decode_blocks(streams, sizes, *a, **kw,
                                             lib=lib)
                   for t, lib in libs.items()}
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
                def run(lib):
                    if d == "encode":
                        return lambda: bpc_cuda.encode_blocks(
                            blocks, *a, **kw, lib=lib)
                    return lambda: bpc_cuda.decode_blocks(
                        streams, sizes, *a, **kw, lib=lib)
                samples = {"other": [], "this": []}
                for t in ("other", "this", "this", "other"):
                    samples[t] += _times(run(libs[t]))
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
