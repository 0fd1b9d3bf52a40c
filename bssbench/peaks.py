"""Published peaks of the cards the benchmark runs on, and the least time of an operation against them.

NVIDIA's H100 SXM data sheet, dense rates without sparsity, at the full
700 W: 495 TFLOP/s on TF32 tensor cores, 67 TFLOP/s in float32 outside
them, 3.35 TB/s of HBM3. The compute peak the rooflines take is TF32's: no
float32-accurate implementation (a 3xTF32 split included) can then read
over 100%. A card whose name is not here has no peak, and its rooflines are
not read.
"""

from typing import Optional

PEAKS = {
    "NVIDIA H100 80GB HBM3": {"flops": 495e12, "bytes_per_s": 3.35e12},
}


def least_seconds(device_name: str, flops: float, n_bytes: float) -> Optional[float]:
    """The larger of ``flops`` over the compute peak and ``n_bytes`` over the memory bandwidth, or None."""
    peak = PEAKS.get(device_name)
    if peak is None:
        return None
    return max(flops / peak["flops"], n_bytes / peak["bytes_per_s"])

