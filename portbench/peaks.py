"""The yardstick of the rooflines: one H100's published peaks and the
bytes a kernel's frame needs.

Peaks: NVIDIA's data sheet of the H100 SXM, dense rates, at its full 700 W
power limit: 3.35 TB/s of HBM3 and 67 TFLOP/s in float32 outside the
tensor cores.  `bound` is `chip_smoke.bound`, copied: a kernel's least
time is its bytes over the memory rate or its operations over the float32
rate, whichever is larger.

Bytes count each input read once and each output written once, from the
shapes of what the frame needs (its rays, the scene's tables, the channels
and splat rows that later passes consume), whatever a kernel happens to
write; operations that depend on the data (pair tests, walk rows) are not
counted yet, so these bounds are the bytes' alone.
"""
from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12

PACK_ROW_BYTES = 48 * 4  # the triangle pack's row
LIGHT_ROW_BYTES = 13 * 4
K1_PIXEL_WORDS = 4 + 20  # K1's own-pixel result (rgba) and G-buffer rows


def bound(n_bytes: float, flops: float) -> dict:
    """The least time of a function: bytes over the memory rate or flops
    over the float32 rate, whichever is larger."""
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S * 1e3, flops / F32_FLOPS_PER_S * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes_ms": t_bytes, "operations_ms": t_ops}


def k1_frame_bytes(width: int, height: int, depth: int, n_tris: int, n_lights: int) -> int:
    """K1 on a frame: it reads the triangle pack and the light rows and
    writes each pixel's result, its G-buffer rows and a splat target and
    payload (int32 each) a light-tracing depth."""
    n = width * height
    return (n_tris * PACK_ROW_BYTES + n_lights * LIGHT_ROW_BYTES
            + n * 4 * (K1_PIXEL_WORDS + 2 * depth))
