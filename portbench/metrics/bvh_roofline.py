"""bvh_roofline: the BVH kernels' least time a frame by bytes
(`peaks.bound` of `frame_bytes`) over their device time a frame (every
device operation whose name contains `bvh_`, as `bvh_ms`), in %.

The bytes are those the algorithm needs, whatever implements it, counted
from the BDPT algorithm at the cell's width, height and depth d, never
from the program's launches (`frame_rays`, one ray a pixel a batch):

- closest-hit batches, 2d: the G-buffer's camera rays, the camera
  subpath's d - 1 extensions and the light subpath's d;
- any-hit batches, 3: estimator 1's shadow rays (d a pixel), estimator
  3's connections (a ray a pixel for each (s, t) with 1 <= s <= d - 1,
  t >= 0, 2 <= s + t <= d) and estimator 2's rays to the camera (d);
- each ray's origin, direction and interval read once (32 B) and its
  answer written once: t, the triangle and two barycentrics (16 B) for a
  closest hit, one byte for an any hit;
- for each batch, the scene read once: each triangle's three vertices
  (36 B) and a binary tree over leaves of at most 4 triangles, each inner
  node's two child boxes and links (56 B).

Operations that depend on the data (boxes and triangles a ray visits) are
not counted, so the share is by the bytes alone and reads low for a walk
that is bound by its latency."""
import math

import devtrace
import peaks

RAY_BYTES = 32          # origin, direction, t_min, t_max: float32 each
CLOSEST_BYTES = 16      # t, triangle id, u, v
ANY_HIT_BYTES = 1       # occluded or not
TRIANGLE_BYTES = 36     # three float32 vertices
INNER_NODE_BYTES = 56   # two child boxes (12 float32) and two int32 links
LEAF_TRIANGLES = 4


def connections(depth: int) -> int:
    """Estimator 3's (s, t) pairs a pixel: 1 <= s <= depth - 1, t >= 0,
    2 <= s + t <= depth."""
    return sum(1 for total in range(2, depth + 1) for s in range(1, depth)
               if total - s >= 0)


def frame_rays(width: int, height: int, depth: int) -> dict:
    """Rays a frame of the BDPT algorithm by kind: {closest, any_hit}, and
    its batches {closest_batches, any_hit_batches}."""
    n = width * height
    return {"closest": n * 2 * depth, "any_hit": n * (2 * depth + connections(depth)),
            "closest_batches": 2 * depth, "any_hit_batches": 3}


def frame_bytes(width: int, height: int, depth: int, n_tris: int) -> int:
    rays = frame_rays(width, height, depth)
    inner = max(math.ceil(n_tris / LEAF_TRIANGLES) - 1, 0)
    scene = n_tris * TRIANGLE_BYTES + inner * INNER_NODE_BYTES
    batches = rays["closest_batches"] + rays["any_hit_batches"]
    return (rays["closest"] * (RAY_BYTES + CLOSEST_BYTES)
            + rays["any_hit"] * (RAY_BYTES + ANY_HIT_BYTES) + batches * scene)


def read(ctx):
    us = devtrace.kernel_us(ctx.device, ctx.window, "bvh_")
    if us <= 0 or not ctx.traced_frames:
        return None
    need = frame_bytes(ctx.width, ctx.height, ctx.depth, ctx.n_tris)
    bound_ms = peaks.bound(need, 0.0)["bound_ms"]
    return 100.0 * bound_ms * ctx.traced_frames / (us / 1e3)
