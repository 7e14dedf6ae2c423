"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates, at the full 700 W power limit)."""

HBM_BYTES_PER_S = 3.35e12
#: float64 outside the tensor cores (an FMA counts as two operations)
FP64_OPS_PER_S = 34e12
FP32_OPS_PER_S = 67e12
BF16_OPS_PER_S = 989e12


def bound_s(n_bytes: float, n_ops: float = 0.0,
            ops_per_s: float = FP64_OPS_PER_S) -> float:
    """The least time the card could take: the larger of the bytes over
    the HBM bandwidth and the operations over the peak rate."""
    return max(n_bytes / HBM_BYTES_PER_S, n_ops / ops_per_s)
