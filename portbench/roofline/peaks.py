"""Published peaks of one NVIDIA H100 SXM (data sheet, dense, at the full
700 W power limit; the run's notes carry the card's own limit)."""

BF16_FLOPS = 989e12
TF32_FLOPS = 495e12
FP32_FLOPS = 67e12
HBM_BYTES = 3.35e12

PUBLISHED = {"bf16_flops": BF16_FLOPS, "tf32_flops": TF32_FLOPS,
             "fp32_flops": FP32_FLOPS, "hbm_bytes_per_s": HBM_BYTES}

BY_NAME = {"bf16": BF16_FLOPS, "tf32": TF32_FLOPS, "fp32": FP32_FLOPS}


def bound_s(flops: float, nbytes: float, peak_flops: float) -> float:
    """The least time the card could take: the larger of operations over
    the peak rate and bytes over the memory's."""
    return max(flops / peak_flops, nbytes / HBM_BYTES)
