"""Multi-host video: per-host frame slabs, merged in rank order.

Counterpart of `picsong_tpu.dist.multihost`, with its names and
signatures (plus `device`). Each host (one process):

  - reads ITS OWN contiguous slab of frames from the shared input (no
    frame moves between hosts: video frames are independent),
  - encodes the slab with the local pipelined engine (`engine/video.py`),
  - writes a part file `<out>.part<rank>` and its `_SIZE` sidecar,

and rank 0 concatenates the parts in rank order into the codestream file:
the file is an appended sequence of per-frame codestreams, so the concat
of contiguous slabs is exactly the single-host file. Decode is the mirror,
each host decoding its slab through the `_SIZE` prefix offsets.

The control plane is `torch.distributed` on the gloo backend, where the
JAX package has `jax.distributed`: the data plane needs no collective, only
two barriers (parts written, parts merged), and gloo runs on any host.
NCCL would add nothing here, and it cannot run two ranks on one card,
which is the only multi-rank layout a one-card machine has. The only
global values are the part lengths, exchanged through the filesystem at
merge time; each host's bitplane counts are its own batches'.

Scaling efficiency comes from per-host wall times:
  efficiency = T_1 / (N * max_h T_h)   for the same total frame count.
"""

from __future__ import annotations

import os
import shutil
from dataclasses import dataclass

import torch.distributed as dist

from ..core.header import CodecConfig
from ..core.image_io import read_sizes
from ..engine.video import VideoStats, decode_video, encode_video
from .sharded import shares


def init_distributed(coordinator_address: str | None = None,
                     num_processes: int | None = None,
                     process_id: int | None = None) -> tuple[int, int]:
    """Join the process group (one process per host) on gloo.

    With an address ("host:port") the group meets at tcp://<address>, with
    `num_processes` and `process_id`; without one, where torchrun's
    MASTER_ADDR is set, at its environment (MASTER_ADDR, MASTER_PORT,
    WORLD_SIZE, RANK). With neither this is the single-process no-op
    returning (0, 1): the same code runs on a laptop, one card and a
    cluster. Returns (rank, world size)."""
    if dist.is_initialized():
        return rank_and_size()
    if coordinator_address is not None:
        dist.init_process_group("gloo",
                                init_method=f"tcp://{coordinator_address}",
                                world_size=num_processes, rank=process_id)
    elif "MASTER_ADDR" in os.environ:
        dist.init_process_group("gloo")
    else:
        return 0, 1
    return rank_and_size()


def rank_and_size() -> tuple[int, int]:
    """(rank, world size) of the process group, or (0, 1) outside one."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def _barrier(n: int) -> None:
    if n > 1:
        dist.barrier()


def frame_slab(frames: int, num_hosts: int, host_id: int) -> tuple[int, int]:
    """Contiguous frame range [start, stop) owned by a host.

    Contiguous slabs (not round-robin stripes) keep each host's disk
    reads sequential and make the rank-ordered merge a plain concat."""
    return shares(frames, num_hosts)[host_id]


def part_path(output_path: str, host_id: int) -> str:
    return f"{output_path}.part{host_id}"


def encode_video_part(input_path: str, output_path: str, cfg: CodecConfig,
                      luts, params, frames: int, num_hosts: int,
                      host_id: int, batch: int = 8, progress: bool = False,
                      device="cuda") -> VideoStats:
    """Encode this host's frame slab into its rank part file."""
    start, stop = frame_slab(frames, num_hosts, host_id)
    if stop <= start:
        # still create empty part files so merge_parts needs no special case
        for suffix in ("", "_SIZE"):
            open(part_path(output_path, host_id) + suffix, "w").close()
        return VideoStats()
    return encode_video(input_path, part_path(output_path, host_id), cfg,
                        luts, params, frames=stop - start, batch=batch,
                        progress=progress, frame_offset=start, device=device)


def encode_video_multihost(input_path: str, output_path: str,
                           cfg: CodecConfig, luts, params, frames: int,
                           batch: int = 8, progress: bool = False,
                           device="cuda") -> VideoStats:
    """Full multi-host encode: slab encode -> barrier -> rank-0 merge ->
    barrier.

    Call init_distributed first; in a single process this degenerates to
    a plain encode_video with a rename."""
    pid, n = rank_and_size()
    stats = encode_video_part(input_path, output_path, cfg, luts, params,
                              frames, n, pid, batch=batch, progress=progress,
                              device=device)
    _barrier(n)
    if pid == 0:
        merge_parts(output_path, n)
    _barrier(n)
    return stats


def decode_video_part(input_path: str, output_path: str, cfg: CodecConfig,
                      luts, params, num_hosts: int, host_id: int,
                      batch: int = 8, progress: bool = False,
                      device="cuda") -> VideoStats:
    """Decode this host's frame slab into its rank part file (raw planes).

    The `_SIZE` sidecar's prefix offsets give every host random access to
    its slab without touching other hosts' bytes (the reference's
    resume-at-frame-i offsets, IOManager.ipp:196-208)."""
    n_comp = 3 if cfg.is_rgb else 1
    total = len(read_sizes(input_path)) // n_comp
    start, stop = frame_slab(total, num_hosts, host_id)
    part = part_path(output_path, host_id)
    if stop <= start:
        open(part, "w").close()
        return VideoStats()
    return decode_video(input_path, part, cfg, luts, params, batch=batch,
                        progress=progress, frame_offset=start,
                        frames=stop - start, device=device)


def decode_video_multihost(input_path: str, output_path: str,
                           cfg: CodecConfig, luts, params, batch: int = 8,
                           progress: bool = False,
                           device="cuda") -> VideoStats:
    """Full multi-host decode: slab decode -> barrier -> rank-0 raw concat
    -> barrier."""
    pid, n = rank_and_size()
    stats = decode_video_part(input_path, output_path, cfg, luts, params,
                              n, pid, batch=batch, progress=progress,
                              device=device)
    _barrier(n)
    if pid == 0:
        merge_raw_parts(output_path, n)
    _barrier(n)
    return stats


def merge_raw_parts(output_path: str, num_hosts: int) -> None:
    """Rank-ordered concat of decoded raw part files (rank 0). Raw planar
    frames have no sidecar; contiguous slabs concat to exactly the
    single-host output file."""
    with open(output_path, "wb") as out:
        for h in range(num_hosts):
            part = part_path(output_path, h)
            with open(part, "rb") as f:
                shutil.copyfileobj(f, out, length=16 * 1024 * 1024)
            os.remove(part)


def merge_parts(output_path: str, num_hosts: int) -> None:
    """Rank-ordered concat of part files + merged _SIZE sidecar (rank 0)."""
    sizes: list[str] = []
    with open(output_path, "wb") as out:
        for h in range(num_hosts):
            part = part_path(output_path, h)
            with open(part, "rb") as f:
                # stream the concat: rank 0's memory must not grow with the
                # whole compressed video
                shutil.copyfileobj(f, out, length=16 * 1024 * 1024)
            with open(part + "_SIZE") as f:
                tok = f.read().strip()
                if tok:
                    sizes.append(tok)
            os.remove(part)
            os.remove(part + "_SIZE")
    with open(output_path + "_SIZE", "w") as f:
        f.write(",".join(sizes))


@dataclass
class ScalingReport:
    """Frames/s scaling-efficiency accounting."""

    frames: int
    num_hosts: int
    host_wall_s: list[float]
    single_host_wall_s: float | None = None

    @property
    def aggregate_fps(self) -> float:
        return self.frames / max(self.host_wall_s)

    @property
    def efficiency(self) -> float | None:
        """T_1 / (N * max_h T_h); None when no single-host baseline ran."""
        if self.single_host_wall_s is None:
            return None
        return self.single_host_wall_s / (self.num_hosts
                                          * max(self.host_wall_s))

    def as_dict(self) -> dict:
        return dict(frames=self.frames, num_hosts=self.num_hosts,
                    host_wall_s=self.host_wall_s,
                    single_host_wall_s=self.single_host_wall_s,
                    aggregate_fps=self.aggregate_fps,
                    efficiency=self.efficiency)
