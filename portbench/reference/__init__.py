"""The plain reference of the benchmark's correctness check.

A renderer of the same frames as the port, written from the semantics that
the JAX package and the reference app's shaders state, not from the port's
code: one path a pixel followed vertex by vertex, vectorized over the
pixels, with every triangle tested against every ray, in float64.  It
imports nothing of the port and takes nothing the port made: the scene
comes from the configuration's own file, the camera from the pose.

- `rng`: the app's per-pixel TEA seed and LCG stream, as integers;
- `scene`: the triangles, materials, lights and camera of a configuration;
- `bdpt`: the G-buffer and the bidirectional path tracer's frame;
- `bmfr`: the denoiser, its fit a least-squares solve a block;
- `render`: frames of a camera sequence, the accumulation, and the
  control (the same in bfloat16).

What it shares with the port is only what both are held to: the integer
random streams, the order of the estimators and their reference quirks
(see `bdpt`), and the denoiser's feature columns and skip rule.
"""
