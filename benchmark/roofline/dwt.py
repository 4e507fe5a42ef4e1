"""The work of the lifting DWT over one image (X2 forward with the DC
shift, colour transform, quantization and tiling; X4 back): the samples
read once and the int32 codeblocks written once (X4 the reverse), and the
lifting's operations, 7 int32 a sample a level for 5/3 (a predict of 3 and
an update of 4, both passes together) or 14 float32 for 9/7, over each
level's plane."""

from . import peaks


def least_seconds(cfg) -> float:
    ah, aw = cfg.padded
    samples = ah * aw * cfg.n_planes_in
    sample_bytes = 1 if cfg.bps <= 8 else 2
    nbytes = samples * (sample_bytes + 4)
    lifted = sum(samples / 4 ** level for level in range(cfg.wavelet_levels))
    if cfg.is_lossy:
        return peaks.least_seconds(14 * lifted, nbytes,
                                   peaks.FLOAT32_OPS_PER_S)
    return peaks.least_seconds(7 * lifted, nbytes, peaks.INT32_OPS_PER_S)
