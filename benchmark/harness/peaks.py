"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense rates,
at the full 700 W power limit). A roofline share is stated against these,
with the card's power limit printed beside it by the run."""

HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS = 989e12
F32_FLOPS = 67e12  # outside the tensor cores
INT8_OPS = 1979e12


def bound_s(n_bytes: float, flops: float, peak_flops: float) -> float:
    """The least time the chip could take: the larger of bytes over the HBM
    bandwidth and operations over the peak that fits the arithmetic."""
    return max(n_bytes / HBM_BYTES_PER_S, flops / peak_flops)
