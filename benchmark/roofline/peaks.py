"""The NVIDIA H100 SXM's published peaks, the roofline's ceilings: HBM3
at 3.35 TB/s; int32 operations outside the tensor cores at 132 SMs x 64
lanes x 1.98 GHz; float32 outside the tensor cores at 67 TFLOP/s. They
assume the full 700 W power limit; a run reports the card's limit
beside them."""

HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 132 * 64 * 1.98e9
FLOAT32_OPS_PER_S = 67e12


def least_seconds(ops: float, nbytes: float, ops_rate: float) -> float:
    """The least time the chip needs for this work: the larger of its
    bytes over the memory rate and its operations over the compute rate."""
    return max(nbytes / HBM_BYTES_PER_S, ops / ops_rate)
