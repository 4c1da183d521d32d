"""The yardstick's arithmetic: published peaks of the card and the
operations and bytes of the work a cell asks for, counted from shapes and
table hits (never from timings)."""

# One NVIDIA H100 SXM, NVIDIA's data sheet, dense rates without sparsity,
# at the full 700 W power limit: FLOP/s by the type of the products (f32
# outside the tensor cores), and HBM3 bytes/s
PEAK_FLOPS = {"float32": 67e12, "tf32": 495e12, "bfloat16": 989e12}
PEAK_BYTES = 3.35e12


def least_seconds(flops: float, nbytes: float, kind: str = "float32"
                  ) -> float:
    """The least time the card could take: the larger of the operations
    over the peak rate of their type and the bytes over the memory rate."""
    return max(flops / PEAK_FLOPS[kind], nbytes / PEAK_BYTES)
