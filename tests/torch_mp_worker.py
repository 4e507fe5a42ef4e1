"""One 'host' of a real multi-process run of the port's multi-host video
path (spawned by tests/test_torch_multihost.py).

The process joins a gloo process group at 127.0.0.1:<port>, encodes its
frame slab on the CPU, meets the other ranks at the barriers while rank 0
merges the parts, then does the same for decode: the init_distributed +
barrier path that a sequential simulation in one process cannot reach.

    python tests/torch_mp_worker.py RANK WORLD_SIZE PORT TMPDIR
"""

import os
import sys

# `python tests/torch_mp_worker.py` puts tests/ on sys.path, not the
# repository root
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main() -> None:
    import torch.distributed as dist

    from picsong_tpu_torch.core.header import CodecConfig
    from picsong_tpu_torch.core.lut import LUTParams, neutral_lut
    from picsong_tpu_torch.dist import multihost as mh

    pid, n = int(sys.argv[1]), int(sys.argv[2])
    port, tmp = sys.argv[3], sys.argv[4]
    got = mh.init_distributed(coordinator_address=f"127.0.0.1:{port}",
                              num_processes=n, process_id=pid)
    assert got == (pid, n), f"distributed init returned {got}"
    try:
        params = LUTParams()
        cfg = CodecConfig(width=64, height=64, wavelet_levels=1, frames=5)
        luts = [neutral_lut(params, 1, 2)]
        mh.encode_video_multihost(f"{tmp}/v.raw", f"{tmp}/mp.enc", cfg, luts,
                                  params, frames=5, batch=2, device="cpu")
        mh.decode_video_multihost(f"{tmp}/mp.enc", f"{tmp}/mp_dec.raw", cfg,
                                  luts, params, batch=2, device="cpu")
    finally:
        dist.destroy_process_group()
    print(f"WORKER-OK {pid}")


if __name__ == "__main__":
    main()
