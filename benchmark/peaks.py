"""The card's published peaks (NVIDIA H100 SXM data sheet, dense rates at
the full 700 W): HBM bandwidth and the float32 rate outside the tensor
cores. A roofline share is the least time these allow over the time a
kernel took; the card's power limit is printed beside every run."""

HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12


def least_seconds(nbytes, ops=0.0):
    """The least time of a kernel that moves `nbytes` and performs `ops`
    float32 operations."""
    return max(nbytes / HBM_BYTES_PER_S, ops / F32_OPS_PER_S)
