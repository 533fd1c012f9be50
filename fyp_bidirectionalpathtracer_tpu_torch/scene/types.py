"""Scene data structures as dataclasses of tensors.

Port of `fyp_bidirectionalpathtracer_tpu/scene/types.py`: the flax
`struct.dataclass` pytrees become frozen dataclasses, updated with
`dataclasses.replace`.  The BVH arrays are not carried: the slice's
megakernel tests every triangle, and the bake only needs the BVH's
triangle order.
"""
from __future__ import annotations

from dataclasses import dataclass

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
    """Material table; texture slots are -1 (the slice is untextured)."""

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
    """The dummy 1x1 atlas of an untextured scene."""

    data: torch.Tensor            # [1,1,1,4]
    sizes: torch.Tensor           # [1,2] int32


@dataclass(frozen=True)
class GeometryArrays:
    """One global triangle soup with a per-triangle material id."""

    positions: torch.Tensor       # [V,3]
    normals: torch.Tensor         # [V,3]
    uvs: torch.Tensor             # [V,2]
    indices: torch.Tensor         # [F,3] int32
    material_id: torch.Tensor     # [F] int32


@dataclass(frozen=True)
class SceneData:
    geometry: GeometryArrays
    materials: MaterialArray
    textures: TextureAtlas
    lights: LightArray
    camera: CameraData
    env_map: torch.Tensor         # [1,1,4]
