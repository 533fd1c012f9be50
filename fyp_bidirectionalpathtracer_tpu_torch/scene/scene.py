"""Host scene container and bake.

Port of `Scene.from_built(...).bake()` in `fyp_bidirectionalpathtracer_tpu/
scene/scene.py` (`:60`, `:145`) for untextured scenes with a constant 1x1
env map.  Triangles are permuted by the same `accel/bvh.build_bvh` call
(`scene.py:179-182`), so triangle ids match the JAX bake.

The bake runs on the host in float32; the two tables the kernels read
(the [T_pad, 48] triangle pack and the [L, 13] light rows) are moved to the
device named at bake time: the card unless the caller names another.
"""
from __future__ import annotations

from dataclasses import dataclass, field, fields, replace

import numpy as np
import torch

from .. import cuda
from ..accel import bvh as bvh_mod
from ..accel.traverse import make_intersector
from ..accel.tri_pack import TriSoA, bake_triangles, pack_shaded_tris_lane
from ..models.procedural import BuiltScene, MaterialDesc
from . import camera as camera_mod
from .lights import light_rows, make_light_array
from .types import (
    CameraData,
    GeometryArrays,
    LightArray,
    MaterialArray,
    SceneData,
    TextureAtlas,
)

_TEXTURES_ITEM = "ROADMAP Queue 1 item 10 (textured scenes)"
_ENV_ITEM = "ROADMAP Queue 1 item 10 (env maps)"
_ALPHA_ITEM = "ROADMAP Queue 1 item 10 (alpha-tested materials)"


@dataclass
class Scene:
    """Mutable host scene; `bake()` freezes it into tensors."""

    meshes: list = field(default_factory=list)        # list[MeshData]
    materials: list = field(default_factory=list)     # list[MaterialDesc]
    lights: list = field(default_factory=list)        # list[dict]
    camera: CameraData | None = None
    env_map: np.ndarray | None = None                 # [1,1,4] or None
    lighting_scale: float = 1.0
    name: str = "scene"

    @classmethod
    def from_built(cls, built: BuiltScene, aspect: float | None = None) -> "Scene":
        cam_kw = dict(built.camera)
        if aspect is not None:
            cam_kw["aspect"] = aspect
        cam = camera_mod.make_camera(**cam_kw) if cam_kw else None
        return cls(meshes=list(built.meshes),
                   materials=list(built.materials) or [MaterialDesc()],
                   lights=list(built.lights), camera=cam)

    def apply_default_fixups(self):
        """A default directional light if there is none and a bounding-box
        camera if none was given (SceneLoaderWrapper.cpp:65-102)."""
        if not self.lights:
            self.lights.append({"type": "dir", "dir": (0.13, 0.27, 0.9),
                                "intensity": (0.9, 0.9, 0.9)})
        if self.camera is None:
            pos = np.concatenate([m.positions for m in self.meshes])
            lo, hi = pos.min(axis=0), pos.max(axis=0)
            center = (lo + hi) * 0.5
            radius = float(np.linalg.norm(hi - lo)) * 0.5
            eye = center + np.asarray([0.0, 0.0, -2.0]) * max(radius, 1e-3)
            self.camera = camera_mod.make_camera(
                pos=tuple(eye), target=tuple(center),
                near_z=max(0.1, 0.1 * radius), far_z=max(1000.0, 10.0 * radius))
        return self

    def bake(self, max_lights: int | None = None, leaf_size: int = 4,
             device="cuda") -> "BakedScene":
        """Bake onto `device`: the card unless the caller names another
        (`device="cpu"` runs every kernel's plain version)."""
        device = cuda.resolve_device(device)
        if self.camera is None or not self.lights:
            self.apply_default_fixups()
        mats = self.materials or [MaterialDesc()]
        for md in mats:
            if any(getattr(md, k, None) is not None for k in (
                    "base_color_image", "specular_image", "emissive_image",
                    "normal_map_image")):
                raise NotImplementedError(
                    f"textured material {md.name!r}: the port's slice is "
                    f"untextured; see {_TEXTURES_ITEM}")
            if md.base_color[3] < md.alpha_threshold:
                raise NotImplementedError(
                    f"alpha-tested material {md.name!r}; see {_ALPHA_ITEM}")
        if self.env_map is not None and tuple(np.shape(self.env_map)[:2]) != (1, 1):
            raise NotImplementedError(
                f"env map of shape {np.shape(self.env_map)}; see {_ENV_ITEM}")

        # ---- geometry: all meshes flattened into one soup ----
        pos, nrm, uv, idx, mat = [], [], [], [], []
        voff = 0
        for m in self.meshes:
            pos.append(np.asarray(m.positions, np.float32))
            nrm.append(np.asarray(m.normals, np.float32))
            uv.append(np.asarray(m.uvs, np.float32))
            idx.append(np.asarray(m.indices, np.int64) + voff)
            mat.append(np.full(len(m.indices), m.material, np.int32))
            voff += len(m.positions)
        positions = np.concatenate(pos)
        indices = np.concatenate(idx)
        geometry = GeometryArrays(
            positions=torch.from_numpy(positions),
            normals=torch.from_numpy(np.concatenate(nrm)),
            uvs=torch.from_numpy(np.concatenate(uv)),
            indices=torch.from_numpy(indices.astype(np.int32)),
            material_id=torch.from_numpy(np.concatenate(mat)),
        )
        tree = bvh_mod.build_bvh(positions, indices, leaf_size=leaf_size)
        order = (torch.from_numpy(np.asarray(tree["tri_order"], np.int64))
                 if len(tree["tri_order"]) else None)
        tris = bake_triangles(geometry, order)

        m_count = len(mats)
        col = lambda key, dt: np.asarray(  # noqa: E731
            [getattr(md, key) for md in mats], dt)
        neg1 = torch.full((m_count,), -1, dtype=torch.int32)
        materials = MaterialArray(
            base_color=torch.from_numpy(col("base_color", np.float32)),
            specular=torch.from_numpy(col("specular", np.float32)),
            emissive=torch.from_numpy(col("emissive", np.float32)),
            ior=torch.from_numpy(col("ior", np.float32)),
            shading_model=torch.from_numpy(col("shading_model", np.int32)),
            double_sided=torch.from_numpy(col("double_sided", bool)),
            alpha_threshold=torch.from_numpy(col("alpha_threshold", np.float32)),
            base_color_tex=neg1, specular_tex=neg1, emissive_tex=neg1,
            normal_tex=neg1,
        )
        lights = make_light_array(
            [{**light, "intensity": tuple(
                np.asarray(light["intensity"]) * self.lighting_scale)}
             for light in self.lights],
            capacity=max_lights,
        )
        env = (torch.as_tensor(np.asarray(self.env_map, np.float32))
               if self.env_map is not None
               else torch.zeros((1, 1, 4), dtype=torch.float32))
        data = SceneData(
            geometry=geometry, materials=materials,
            textures=TextureAtlas(data=torch.ones((1, 1, 1, 4)),
                                  sizes=torch.ones((1, 2), dtype=torch.int32)),
            lights=lights, camera=self.camera, env_map=env,
        )
        return BakedScene.build(data, tris, device)


@dataclass(frozen=True)
class BakedScene:
    """Host scene arrays plus the kernels' tables on `device`."""

    data: SceneData
    tris: TriSoA
    tri_pack: torch.Tensor     # [T_pad, 48] float32 on device
    light_rows: torch.Tensor   # [L, 13] float32 on device
    # alpha-tested materials need the masked restart loops of ops/alpha.py;
    # the bake refuses them, so a bake never sets this
    has_alpha: bool = False
    # every frame of this scene runs the kernels' plain versions on its
    # device (`replace(baked, plain=True)`): the chain the kernels are held
    # against on the card
    plain: bool = False

    @classmethod
    def build(cls, data: SceneData, tris: TriSoA, device) -> "BakedScene":
        return cls(
            data=data, tris=tris,
            tri_pack=pack_shaded_tris_lane(tris, data.materials).to(device),
            light_rows=light_rows(data.lights).to(device),
        )

    @property
    def device(self) -> torch.device:
        return self.tri_pack.device

    @property
    def n_tris(self) -> int:
        return int(self.tris.v0.shape[0])

    def with_camera(self, cam: CameraData) -> "BakedScene":
        return replace(self, data=replace(self.data, camera=cam))

    def intersector(self):
        """The wavefront's `intersect` closure (accel/traverse.py) over this
        bake's pack."""
        if self.has_alpha:
            raise NotImplementedError(f"alpha-tested materials; see {_ALPHA_ITEM}")
        return make_intersector(self.tri_pack, self.n_tris, plain=self.plain)


# --------------------------------------------------- parameters carried across
_GROUPS = (("geometry", GeometryArrays), ("materials", MaterialArray),
           ("lights", LightArray), ("camera", CameraData))


def baked_scene_arrays(baked: BakedScene) -> dict:
    """Flat {"group.field": np.ndarray} of a bake: tris, geometry,
    materials, lights, camera and env_map (the inverse of
    baked_scene_from_arrays)."""
    out = {f"tris.{f.name}": np.asarray(getattr(baked.tris, f.name))
           for f in fields(TriSoA)}
    for group, cls in _GROUPS:
        obj = getattr(baked.data, group)
        out.update({f"{group}.{f.name}": np.asarray(getattr(obj, f.name))
                    for f in fields(cls)})
    out["env_map"] = np.asarray(baked.data.env_map)
    return out


def baked_scene_from_arrays(arrays: dict, device="cuda") -> BakedScene:
    """Build the port's BakedScene from a flat dict of numpy arrays with
    the keys of baked_scene_arrays; the JAX package's BakedScene gives one
    by reading the same-named fields, so both packages compute on
    identical inputs.  On the card unless `device` names another."""
    device = cuda.resolve_device(device)
    env = np.asarray(arrays["env_map"], np.float32)
    if env.shape[:2] != (1, 1):
        raise NotImplementedError(f"env map of shape {env.shape}; see {_ENV_ITEM}")

    def build(cls, prefix):
        kw = {}
        for f in fields(cls):
            v = np.asarray(arrays[f"{prefix}.{f.name}"])
            kw[f.name] = int(v) if f.name == "count" else torch.from_numpy(v.copy())
        return cls(**kw)

    groups = {group: build(cls, group) for group, cls in _GROUPS}
    data = SceneData(
        textures=TextureAtlas(data=torch.ones((1, 1, 1, 4)),
                              sizes=torch.ones((1, 2), dtype=torch.int32)),
        env_map=torch.from_numpy(env.copy()), **groups,
    )
    return BakedScene.build(data, build(TriSoA, "tris"), device)
