"""Published peaks of one NVIDIA H100 SXM (data sheet, dense rates, at
its 700 W limit): HBM bytes/s and bfloat16 tensor-core operations/s."""

HBM_BYTES_S = 3.35e12
BF16_FLOPS = 989e12


def least_seconds(nbytes: float, ops: float) -> float:
    """The least time the card could take for this work."""
    return max(nbytes / HBM_BYTES_S, ops / BF16_FLOPS)
