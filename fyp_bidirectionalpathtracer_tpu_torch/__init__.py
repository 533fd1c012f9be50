"""PyTorch / CUDA port of the BDPT renderer for NVIDIA Hopper (H100).

A second package beside the JAX/Pallas renderer in
`fyp_bidirectionalpathtracer_tpu/`, which stays the reference it is held
against.  This slice covers the main path only: the procedural Cornell
box through the whole-frame megakernel, the estimator-2 splat reduction
and temporal accumulation.

Layer map (JAX counterpart in parentheses):
  core/      TEA/LCG RNG, vector helpers, samplers     (core/)
  scene/     scene bake, camera, lights, types          (scene/)
  accel/     triangle pack + frame megakernel K1        (accel/pallas_frame.py)
  ops/       splat compaction K2, tile reduction K3     (ops/compact.py, ops/splat_tile.py)
  passes/    jitter, accumulation, BMFR passthrough     (passes/)
  pipeline/  render_frame_fn and Renderer               (pipeline/renderer.py)
  csrc/      the hand-written CUDA C++ kernels, built by `cuda.py`

Every kernel has a plain PyTorch version in the same module.  A wrapper
runs the plain version only for tensors on the CPU; for a CUDA tensor it
launches its kernel or raises.  The package imports torch and never jax.
"""

__version__ = "0.1.0"
