"""Scene data structures as dataclasses of tensors.

Port of `fyp_bidirectionalpathtracer_tpu/scene/types.py`: the flax
`struct.dataclass` pytrees become frozen dataclasses, updated with
`dataclasses.replace`.  Every tensor here lives on the host; the bake
moves the tables the kernels and the texture taps read to the device
(`scene/scene.BakedScene`).
"""
from __future__ import annotations

from dataclasses import dataclass, fields, replace

import torch

# Light type ids (HostDeviceSharedMacros.h:145-150)
LIGHT_POINT = 0
LIGHT_DIRECTIONAL = 1

# Shading models (HostDeviceSharedMacros.h:70-72)
SHADING_METAL_ROUGH = 0

DEFAULT_MAX_LIGHTS = 16


@dataclass(frozen=True)
class CameraData:
    """Pinhole/thin-lens camera; all fields float32 host tensors.  Derived
    fields come from scene.camera.derive_camera."""

    pos_w: torch.Tensor           # [3]
    target: torch.Tensor          # [3]
    up: torch.Tensor              # [3]
    focal_length: torch.Tensor    # []
    frame_height: torch.Tensor    # []
    aspect: torch.Tensor          # []
    near_z: torch.Tensor          # []
    far_z: torch.Tensor           # []
    focal_distance: torch.Tensor  # []
    aperture_radius: torch.Tensor  # []
    jitter: torch.Tensor          # [2]
    camera_u: torch.Tensor        # [3]
    camera_v: torch.Tensor        # [3]
    camera_w: torch.Tensor        # [3]
    view_proj: torch.Tensor       # [4,4], jittered
    prev_view_proj: torch.Tensor  # [4,4], previous frame, not jittered
    inv_view_proj: torch.Tensor   # [4,4]


@dataclass(frozen=True)
class LightArray:
    """Fixed-capacity analytic light table; `count` lights are valid."""

    pos_w: torch.Tensor              # [L,3]
    dir_w: torch.Tensor              # [L,3]
    intensity: torch.Tensor          # [L,3]
    type: torch.Tensor               # [L] int32
    opening_angle: torch.Tensor      # [L]
    cos_opening_angle: torch.Tensor  # [L]
    penumbra_angle: torch.Tensor     # [L]
    count: int


@dataclass(frozen=True)
class MaterialArray:
    """Material table; texture slots index the atlas (-1: none).  For a
    textured kind the bake overwrites the constant with the texture's mean
    (the base colour's rgb floored at 1e-3), as JAX's bake does."""

    base_color: torch.Tensor      # [M,4]
    specular: torch.Tensor        # [M,4]
    emissive: torch.Tensor        # [M,3]
    ior: torch.Tensor             # [M]
    shading_model: torch.Tensor   # [M] int32
    double_sided: torch.Tensor    # [M] bool
    alpha_threshold: torch.Tensor  # [M]
    base_color_tex: torch.Tensor  # [M] int32
    specular_tex: torch.Tensor    # [M] int32
    emissive_tex: torch.Tensor    # [M] int32
    normal_tex: torch.Tensor      # [M] int32


@dataclass(frozen=True)
class TextureAtlas:
    """All scene textures resampled onto fixed-size slots [T, R, R, 4]
    (JAX `scene/types.TextureAtlas`); an untextured scene has the dummy
    [1, 1, 1, 4] atlas of ones."""

    data: torch.Tensor            # [T, R, R, 4] float32
    sizes: torch.Tensor           # [T, 2] int32 (w, h) of the source images
    # [T, R, R, 16] wrap-packed 2x2 texel neighbourhoods (c00 c10 c01 c11):
    # one gather a bilinear tap
    packed: torch.Tensor | None = None
    # [M*R*R, 12] material-indexed combined texel table: the 2x2 wrap
    # neighbourhoods of base, specular and emissive, u8 a channel, four
    # channels to a 32-bit word (int32 here, the same bits as JAX's uint32)
    combined: torch.Tensor | None = None
    # bake-time facts: does any material carry this texture kind?  False
    # removes the kind's tap (ops/texture.sample_or_constant static_used)
    any_base: bool = True
    any_spec: bool = True
    any_emissive: bool = True

    @property
    def resolution(self) -> int:
        return int(self.data.shape[1]) if self.data.dim() == 4 else 0


@dataclass(frozen=True)
class GeometryArrays:
    """One global triangle soup with a per-triangle material id."""

    positions: torch.Tensor       # [V,3]
    normals: torch.Tensor         # [V,3]
    uvs: torch.Tensor             # [V,2]
    indices: torch.Tensor         # [F,3] int32
    material_id: torch.Tensor     # [F] int32


@dataclass(frozen=True)
class BVHArrays:
    """Flattened threaded BVH (`accel/bvh.build_bvh`), DFS pre-order: an
    inner node's first child is the next node, `node_hit` / `node_miss`
    thread the walk, so it needs no stack."""

    node_min: torch.Tensor        # [N,3]
    node_max: torch.Tensor        # [N,3]
    node_left: torch.Tensor       # [N] int32: leaf -> first triangle
    node_count: torch.Tensor      # [N] int32: leaf -> triangle count (0 inner)
    node_hit: torch.Tensor        # [N] int32: next node if the box is hit
    node_miss: torch.Tensor       # [N] int32: next node if missed (-1 done)
    tri_order: torch.Tensor       # [F] int32 leaf-contiguous permutation


@dataclass(frozen=True)
class SceneData:
    geometry: GeometryArrays
    bvh: BVHArrays
    materials: MaterialArray
    textures: TextureAtlas
    lights: LightArray
    camera: CameraData
    env_map: torch.Tensor         # [1,1,4]


def on_device(obj, device):
    """A dataclass of tensors with every tensor field moved to `device`."""
    return replace(obj, **{f.name: getattr(obj, f.name).to(device) for f in fields(obj)
                           if isinstance(getattr(obj, f.name), torch.Tensor)})
