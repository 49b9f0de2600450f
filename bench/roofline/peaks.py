"""Published peaks of one NVIDIA H100 SXM (data sheet, dense, at the
700 W limit).  Shares are stated against them with the card's power
limit beside them."""
HBM_BYTES_PER_S = 3.35e12
BF16_FLOP_PER_S = 989e12
FP32_FLOP_PER_S = 67e12
MEMORY_BYTES = 80e9


def bound_s(nbytes: float, flops: float,
            flop_rate: float = BF16_FLOP_PER_S) -> float:
    """The least time the chip could take: the larger of the bytes over
    the memory bandwidth and the operations over the compute peak."""
    return max(nbytes / HBM_BYTES_PER_S, flops / flop_rate)
