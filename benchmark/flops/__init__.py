"""Operation and byte counts of the benchmark's work, and the card's peaks.

Counts follow the work's shapes, never a route's passes: a float32
product counts once whatever the kernel does to compute it (three TF32
passes, say), so a new route cannot move the yardstick.  Only the
networks' products count (convolutions, linears, attention's two
products); resampling, NMS, normalisations and elementwise passes are left
out, so the shares read low, never high.
"""

# NVIDIA H100 SXM, dense, at the 700 W limit (NVIDIA's data sheet).  495
# TFLOP/s is TF32's: the fastest any route takes a float32-class product.
PEAK_FLOPS = {"bf16": 989e12, "f32": 495e12}
PEAK_BYTES_PER_S = 3.35e12
ELEM_BYTES = {"bf16": 2, "f32": 4}


def least_seconds(flops: dict) -> float:
    """The least time, at the peaks, of ``{"bf16": ops, "f32": ops}``."""
    return sum(n / PEAK_FLOPS[k] for k, n in flops.items())
