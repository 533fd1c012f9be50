"""PyTorch / CUDA port of the BDPT renderer for NVIDIA Hopper (H100).

A second package beside the JAX/Pallas renderer in
`fyp_bidirectionalpathtracer_tpu/`, which stays the reference it is held
against.  It covers the JAX package's single-device scenes (constant or
lat-long env maps, textures, normal maps, alpha) on two paths: the
whole-frame megakernel (untextured, at most 2048 triangles) and the
per-bounce wavefront (textured materials, any triangle count: the dense
intersectors up to 2048 triangles, a BVH walk above), each with the
estimator-2 splat reduction, temporal accumulation and the BMFR denoiser
(single device).

Layer map (JAX counterpart in parentheses):
  core/      TEA/LCG RNG, vector helpers, samplers     (core/)
  models/    procedural scenes, pink_room (copies)      (models/)
  utils/     render configuration (a copy), image I/O   (utils/)
             without PIL, golden harness, checkpoint,
             profiler, video writer
  scene/     scene bake, camera, lights, types          (scene/)
  accel/     triangle pack, BVH build (a copy), frame   (accel/)
             megakernel K1, dense intersectors K4a-K4e,
             BVH kernels for K4f-K4j
  ops/       splat K2 + K3, BRDF and materials,         (ops/)
             shading decode, texture taps
  passes/    G-buffer, BDPT wavefront, accumulation,    (passes/)
             BMFR (plain torch, as JAX's is plain jnp),
             the output passes (AO, Lambertian, GI, probe)
  pipeline/  render_frame_fn and Renderer, the CLI       (pipeline/)
             (`python -m ...pipeline.app`), frame profile
  csrc/      the hand-written CUDA C++ kernels, built by `cuda.py`

Every kernel has a plain PyTorch version in the same module.  A wrapper
runs the plain version only for tensors on the CPU; for a CUDA tensor it
launches its kernel or raises.  The package imports torch and nothing of
JAX or of the JAX package.
"""

__version__ = "0.1.0"
