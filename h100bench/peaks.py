"""Published peaks of one NVIDIA H100 SXM5 80 GB (NVIDIA's data sheet, dense
rates without sparsity, at the card's 700 W power limit).  A card set to a
lower limit runs slower under load: every share of a peak is printed beside
the card's limit."""

HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12          # CUDA cores, an FMA counted as two operations
TF32_FLOPS = 495e12
BF16_FLOPS = 989e12
INT8_OPS = 1979e12
POWER_LIMIT_W = 700.0


def bound(nbytes: float, flops: float, peak_flops: float = FP32_FLOPS):
    """The least seconds for ``nbytes`` of memory traffic and ``flops``
    operations on a unit of ``peak_flops``, and which of the two sets it."""
    by_bytes = nbytes / HBM_BYTES_PER_S
    by_ops = flops / peak_flops
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops,
                                                            "operations")
