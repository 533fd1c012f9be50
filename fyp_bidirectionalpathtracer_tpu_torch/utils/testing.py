"""Golden-image regression harness.

Port of `fyp_bidirectionalpathtracer_tpu/utils/testing.py` on the port's
own `utils/image` (no PIL).  The reference tests rendering by screenshot
capture + ImageMagick compare with a tolerance (SampleTest +
RunTestsSet.py:262-289, tolerance 0.01).  Here: render a small
deterministic config and compare its PSNR against a checked-in golden PNG
in `tests/golden/`, the directory the JAX package's goldens live in.
"""
from __future__ import annotations

import os

import numpy as np

from .image import _numpy, psnr, read_png, to_u8, write_png

GOLDEN_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "tests", "golden")


def golden_compare(name: str, img, min_psnr: float = 38.0, update_env: str = "UPDATE_GOLDEN"):
    """Compare `img` (float [H,W,3or4], numpy or a tensor on any device)
    against tests/golden/<name>.png.

    Returns the PSNR.  Set UPDATE_GOLDEN=1 to (re)write goldens.  The
    comparison is in 8-bit space (like the reference's PNG screenshot
    compare), so tiny float drift across devices is tolerated.
    """
    os.makedirs(GOLDEN_DIR, exist_ok=True)
    path = os.path.join(GOLDEN_DIR, f"{name}.png")
    arr = _numpy(img)
    if arr.shape[-1] == 4:
        arr = arr[..., :3]
    arr = np.clip(arr, 0.0, 1.0)
    if os.environ.get(update_env) or not os.path.exists(path):
        write_png(path, arr)
        return float("inf")
    golden = read_png(path)
    got = to_u8(arr).astype(np.float32) / 255.0
    value = psnr(got, golden)
    if value < min_psnr:
        raise AssertionError(
            f"golden mismatch for {name}: PSNR {value:.2f} dB < {min_psnr} dB "
            f"(set UPDATE_GOLDEN=1 to refresh)"
        )
    return value
