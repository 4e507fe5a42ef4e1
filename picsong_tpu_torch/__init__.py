"""PICSONG on PyTorch and CUDA: the codec's device path for NVIDIA Hopper.

A second implementation of the codec beside the JAX package `picsong_tpu`,
which stays the reference it is held against: for the same input, LUT and
configuration the codestreams are byte-identical. Plain tensor work is
PyTorch; the BPC-PaCo entropy coder, the hot loop, is a pair of CUDA C++
kernels written for sm_90a (one warp per 64x64 codeblock, the reference
coder's own mapping), and the two Mosaic probes of `tools/` have their
CUDA counterparts too; each kernel has a plain PyTorch version beside it
that the CPU runs and the tests compare against.

Nothing here imports JAX or `picsong_tpu`: the port keeps its own copies
of the codestream spec, header, LUT parser and image IO (`core/`), reads
the shared LUT data files under `luts/`, and packs codestreams on the
device (`assembly/pack.py`).

Layer map (mirrors picsong_tpu):
  core/spec.py        codec constants and the codestream specification
  core/header.py      CodecConfig and the 9-short header
  core/lut.py         LUT folder parser, neutral tables, group bases
  core/image_io.py    PGM/RAW/codestream files, mirror padding
  core/geometry.py    codeblock bands (host) and tiling (torch reshapes)
  assembly/pack.py    codestream pack/unpack (X3): CPU -> torch ops,
                      CUDA -> the kernels of csrc/pack.cu
  transform/dwt.py    lifting DWT 5/3 (int32) and 9/7 (float32), both ways
  entropy/bpc.py      plain PyTorch BPC-PaCo (cp=2, cp=3, -k) + host metadata
  entropy/bpc_cuda.py device dispatch: CPU -> plain, CUDA -> the kernels
  csrc/               the CUDA C++ kernels (bpc_encode.cu, bpc_decode.cu,
                      dwt_forward.cu, dwt_reverse.cu, pack.cu, probe.cu,
                      probe2.cu)
  kernels.py          nvcc build of csrc/ into build/ and the ctypes binding
  engine/pipeline.py  TorchCodec: gray/RGB, lossless/lossy, 8-16 bit images
  engine/batch.py     BatchCodec: B frames' codeblocks in one BPC launch
  engine/video.py     the pipelined video engine (devices > 1: frame shares)
  engine/cli.py       the reference-compatible command line (-sharded N)
  dist/sharded.py     device placement, row-sharded ShardedCodec (explicit
                      halo and tiling exchanges), FrameParallelCodec
  dist/multihost.py   multi-host video slabs on a gloo process group
  tools/probe*.py     the probes' wrappers, plain versions, entry points
  tools/quality_report.py  QUALITY.md's tables (bytes, bpp, PSNR) from
                      TorchCodec; tools/lut_eval.py scores LUT folders
  obs/trace.py        spans (profiler labels at each layer boundary
                      while a profiler records), READBACKS,
                      device_trace (torch.profiler) and busy_ms

Every function takes its device from its tensors or an explicit `device`
argument; there is no global device selection.
"""

__version__ = "0.1.0"
