"""Host scene container and bake.

Port of `Scene.from_built(...).bake()` in `fyp_bidirectionalpathtracer_tpu/
scene/scene.py` (`:60`, `:145`) for scenes with textured or constant
materials and a constant 1x1 env map.  Triangles are permuted by the same
`accel/bvh.build_bvh` call (`scene.py:179-182`), so triangle ids match the
JAX bake; the texture atlas, its wrap-packed and combined u8 tables and the
material constants (texture means baked in) are built as JAX builds them
(`scene.py:184-296`).

The bake runs on the host in float32.  What the kernels and the texture
taps read is moved to the device named at bake time, the card unless the
caller names another: the [T_pad, 48] triangle pack, the [L, 13] light
rows, the BVH node table and the atlas.  The bake raises on what the
port's wavefront does not render yet: alpha-tested materials, normal maps
and env maps larger than 1x1, each naming its ROADMAP item.
"""
from __future__ import annotations

from dataclasses import dataclass, field, fields, replace

import numpy as np
import torch

from .. import cuda
from ..accel import bvh as bvh_mod
from ..accel.cluster import pack_bvh_nodes, pair_tables
from ..accel.intersect import MAX_DENSE_TRIS
from ..accel.traverse import make_intersector
from ..accel.tri_pack import TriSoA, bake_triangles, pack_shaded_tris_lane
from ..models.procedural import BuiltScene, MaterialDesc
from ..ops.alpha import has_alpha_materials
from . import camera as camera_mod
from .lights import light_rows, make_light_array
from .types import (
    SHADING_METAL_ROUGH,
    BVHArrays,
    CameraData,
    GeometryArrays,
    LightArray,
    MaterialArray,
    SceneData,
    TextureAtlas,
    on_device,
)

_ENV_ITEM = "ROADMAP Queue 1 item 10b (lat-long and light-probe env maps)"
_ALPHA_ITEM = "ROADMAP Queue 1 item 10b (alpha-tested materials)"
_NORMAL_MAP_ITEM = "ROADMAP Queue 1 item 10b (normal maps)"


def _resample_image(img: np.ndarray, res: int) -> np.ndarray:
    """Nearest-resample [h,w,4] -> [res,res,4] (host, numpy)."""
    h, w = img.shape[:2]
    ys = (np.arange(res) * h // res).clip(0, h - 1)
    xs = (np.arange(res) * w // res).clip(0, w - 1)
    return img[ys][:, xs].astype(np.float32)


def _check_env(env_map) -> None:
    if env_map is not None and tuple(np.shape(env_map)[:2]) != (1, 1):
        raise NotImplementedError(f"env map of shape {np.shape(env_map)}; see {_ENV_ITEM}")


def _texture_atlas(images, sizes, bc_tex, sp_tex, em_tex, nm_tex, m_count) -> TextureAtlas:
    """The atlas of the resampled images (JAX `scene.py:242-296`)."""
    if not images:
        return TextureAtlas(data=torch.ones((1, 1, 1, 4)),
                            sizes=torch.ones((1, 2), dtype=torch.int32),
                            any_base=False, any_spec=False, any_emissive=False)
    data = np.stack(images)
    rx = np.roll(data, -1, axis=2)
    ry = np.roll(data, -1, axis=1)
    rxy = np.roll(rx, -1, axis=1)
    # the combined per-material table: u8-quantised 2x2 neighbourhoods of
    # base | specular | emissive, one 32-bit word an rgba corner, [M*R*R, 12];
    # built where two or more kinds are textured
    r = data.shape[1]
    combined = None
    n_kinds = int((bc_tex >= 0).any()) + int((sp_tex >= 0).any()) + int((em_tex >= 0).any())
    if n_kinds >= 2 and m_count * r * r * 48 <= 768 * 1024 * 1024:
        q = np.clip(np.rint(data * 255.0), 0, 255).astype(np.uint8)
        qp = np.concatenate([q, np.roll(q, -1, 2), np.roll(q, -1, 1),
                             np.roll(np.roll(q, -1, 2), -1, 1)], -1)  # [T,R,R,16]
        kinds = []
        for slots in (bc_tex, sp_tex, em_tex):
            rows = qp[np.clip(slots, 0, len(images) - 1)]
            rows[slots < 0] = 0  # the constant fallback selects these away
            kinds.append(rows)
        comb = np.concatenate(kinds, -1)  # [M,R,R,48] u8
        combined = np.ascontiguousarray(comb.reshape(m_count * r * r, 48)).view(np.int32)
    # the per-texture packed table serves the lookups the combined one does not
    packed = (np.concatenate([data, rx, ry, rxy], -1)
              if bool((nm_tex >= 0).any()) or combined is None else None)
    return TextureAtlas(
        data=torch.from_numpy(data),
        sizes=torch.from_numpy(np.asarray(sizes, np.int32)),
        packed=None if packed is None else torch.from_numpy(packed),
        combined=None if combined is None else torch.from_numpy(combined),
        any_base=bool((bc_tex >= 0).any()), any_spec=bool((sp_tex >= 0).any()),
        any_emissive=bool((em_tex >= 0).any()))


def _tex_defer_ok(materials: MaterialArray) -> bool:
    """The deferred-texture megakernel's static gate (JAX `scene.py:
    347-358`): base colour textured, and nothing non-linear (specular maps,
    normal maps, a metal-rough material whose metalness mixes the base
    texture into the specular colour)."""
    bc = materials.base_color_tex.numpy() >= 0
    metal_mix = (bc & (materials.shading_model.numpy() == SHADING_METAL_ROUGH)
                 & (materials.specular.numpy()[:, 2] > 0.0))
    return bool(bc.any() and not (materials.specular_tex.numpy() >= 0).any()
                and not (materials.normal_tex.numpy() >= 0).any() and not metal_mix.any())


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

    def bake(self, atlas_res: int = 256, max_lights: int | None = None,
             leaf_size: int = 4, device="cuda") -> "BakedScene":
        """Bake onto `device`: the card unless the caller names another
        (`device="cpu"` runs every kernel's plain version)."""
        device = cuda.resolve_device(device)
        if self.camera is None or not self.lights:
            self.apply_default_fixups()
        mats = self.materials or [MaterialDesc()]
        for md in mats:
            if getattr(md, "normal_map_image", None) is not None:
                raise NotImplementedError(
                    f"normal-mapped material {md.name!r}; see {_NORMAL_MAP_ITEM}")
        _check_env(self.env_map)

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
        bvh = BVHArrays(**{k: torch.from_numpy(np.asarray(v)) for k, v in tree.items()})
        order = (torch.from_numpy(np.asarray(tree["tri_order"], np.int64))
                 if len(tree["tri_order"]) else None)
        tris = bake_triangles(geometry, order)

        # ---- materials and the texture atlas (JAX scene.py:184-296) ----
        images: list[np.ndarray] = []
        sizes: list = []

        def add_image(img):
            if img is None:
                return -1
            images.append(_resample_image(np.asarray(img, np.float32), atlas_res))
            sizes.append((img.shape[1], img.shape[0]))
            return len(images) - 1

        m_count = len(mats)
        base_color = np.zeros((m_count, 4), np.float32)
        specular = np.zeros((m_count, 4), np.float32)
        emissive = np.zeros((m_count, 3), np.float32)
        ior = np.full(m_count, 1.5, np.float32)
        shading_model = np.zeros(m_count, np.int32)
        double_sided = np.zeros(m_count, bool)
        alpha_threshold = np.full(m_count, 0.5, np.float32)
        bc_tex, sp_tex, em_tex, nm_tex = (np.full(m_count, -1, np.int32) for _ in range(4))
        for i, md in enumerate(mats):
            base_color[i] = md.base_color
            specular[i] = md.specular
            emissive[i] = md.emissive
            ior[i] = md.ior
            shading_model[i] = md.shading_model
            double_sided[i] = md.double_sided
            alpha_threshold[i] = md.alpha_threshold
            bc_tex[i] = add_image(md.base_color_image)
            sp_tex[i] = add_image(md.specular_image)
            em_tex[i] = add_image(md.emissive_image)
        # a textured kind's constant carries the texture's mean: the
        # direct taps never read it (ops/shading._tap_kinds selects the
        # texel), the mean-albedo bounce decodes do (bounce_tex_mean)
        for i in range(m_count):
            if bc_tex[i] >= 0:
                base_color[i, :3] = np.maximum(images[bc_tex[i]][:, :, :3].mean(axis=(0, 1)),
                                               1e-3)
            if sp_tex[i] >= 0:
                specular[i] = images[sp_tex[i]].mean(axis=(0, 1))
            if em_tex[i] >= 0:
                emissive[i] = images[em_tex[i]][:, :, :3].mean(axis=(0, 1))
        atlas = _texture_atlas(images, sizes, bc_tex, sp_tex, em_tex, nm_tex, m_count)
        materials = MaterialArray(
            base_color=torch.from_numpy(base_color), specular=torch.from_numpy(specular),
            emissive=torch.from_numpy(emissive), ior=torch.from_numpy(ior),
            shading_model=torch.from_numpy(shading_model),
            double_sided=torch.from_numpy(double_sided),
            alpha_threshold=torch.from_numpy(alpha_threshold),
            base_color_tex=torch.from_numpy(bc_tex), specular_tex=torch.from_numpy(sp_tex),
            emissive_tex=torch.from_numpy(em_tex), normal_tex=torch.from_numpy(nm_tex),
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
        data = SceneData(geometry=geometry, bvh=bvh, materials=materials, textures=atlas,
                         lights=lights, camera=self.camera, env_map=env)
        return BakedScene.build(data, tris, device)


@dataclass(frozen=True)
class BakedScene:
    """Host scene arrays plus the kernels' and the taps' tables on `device`."""

    data: SceneData
    tris: TriSoA
    tri_pack: torch.Tensor     # [T_pad, 48] float32 on device
    light_rows: torch.Tensor   # [L, 13] float32 on device
    # [N, 8] float32 on device (accel/cluster.pack_bvh_nodes): K1's textured
    # walk and the counting walks
    bvh_nodes: torch.Tensor
    # the BVH kernels' tables, above MAX_DENSE_TRIS triangles only (the
    # tier that runs them; None below): the two-box BVH [N_inner, 16]
    # (accel/cluster.pack_bvh_pairs, which raises on a tree deeper than
    # the walks' stack) and the pack's Baldwin-Weber rows [T_pad, 12]
    # (accel/cluster.pair_tables)
    bvh_pairs: torch.Tensor | None
    bw_rows: torch.Tensor | None
    atlas: TextureAtlas        # data.textures on device
    # base-colour-only texturing: JAX's deferred-texture megakernel takes
    # such a scene (`_tex_defer_ok`)
    tex_defer_ok: bool = False
    # every frame of this scene runs the kernels' plain versions on its
    # device (`replace(baked, plain=True)`): the chain the kernels are held
    # against on the card
    plain: bool = False

    @classmethod
    def build(cls, data: SceneData, tris: TriSoA, device) -> "BakedScene":
        """The device tables of a bake; raises on alpha-tested materials
        (their restart loops are not ported) and, above MAX_DENSE_TRIS
        triangles, on a BVH deeper than the BVH kernels' stack."""
        if has_alpha_materials(data.materials, data.textures):
            raise NotImplementedError(f"alpha-tested materials; see {_ALPHA_ITEM}")
        tri_pack = pack_shaded_tris_lane(tris, data.materials).to(device)
        rows, pairs = (pair_tables(data.bvh, tri_pack)
                       if int(tris.v0.shape[0]) > MAX_DENSE_TRIS else (None, None))
        return cls(
            data=data, tris=tris, tri_pack=tri_pack,
            light_rows=light_rows(data.lights).to(device),
            bvh_nodes=pack_bvh_nodes(data.bvh).to(device),
            bvh_pairs=pairs, bw_rows=rows,
            atlas=on_device(data.textures, device),
            tex_defer_ok=_tex_defer_ok(data.materials),
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
        bake's pack and BVH tables."""
        return make_intersector(self.tri_pack, self.n_tris, self.bvh_pairs, self.bw_rows,
                                plain=self.plain)


# --------------------------------------------------- parameters carried across
_GROUPS = (("geometry", GeometryArrays), ("bvh", BVHArrays), ("materials", MaterialArray),
           ("lights", LightArray), ("camera", CameraData))
_ATLAS_ARRAYS = ("data", "sizes", "packed", "combined")


def baked_scene_arrays(baked: BakedScene) -> dict:
    """Flat {"group.field": np.ndarray} of a bake: tris, geometry, bvh,
    materials, textures (the combined table as uint32, as JAX holds it; an
    absent table has no key), lights, camera and env_map (the inverse of
    baked_scene_from_arrays)."""
    out = {f"tris.{f.name}": np.asarray(getattr(baked.tris, f.name))
           for f in fields(TriSoA)}
    for group, cls in _GROUPS:
        obj = getattr(baked.data, group)
        out.update({f"{group}.{f.name}": np.asarray(getattr(obj, f.name))
                    for f in fields(cls)})
    for name in _ATLAS_ARRAYS:
        value = getattr(baked.data.textures, name)
        if value is not None:
            out[f"textures.{name}"] = np.asarray(value)
    if "textures.combined" in out:
        out["textures.combined"] = out["textures.combined"].view(np.uint32)
    out["env_map"] = np.asarray(baked.data.env_map)
    return out


def baked_scene_from_arrays(arrays: dict, device="cuda") -> BakedScene:
    """Build the port's BakedScene from a flat dict of numpy arrays with
    the keys of baked_scene_arrays; the JAX package's BakedScene gives one
    by reading the same-named fields, so both packages compute on
    identical inputs.  The atlas's `any_*` flags follow from the material
    texture slots, as the JAX bake sets them.  On the card unless `device`
    names another."""
    device = cuda.resolve_device(device)
    env = np.asarray(arrays["env_map"], np.float32)
    _check_env(env)

    def build(cls, prefix):
        kw = {}
        for f in fields(cls):
            v = np.asarray(arrays[f"{prefix}.{f.name}"])
            kw[f.name] = int(v) if f.name == "count" else torch.from_numpy(v.copy())
        return cls(**kw)

    groups = {group: build(cls, group) for group, cls in _GROUPS}
    if (groups["materials"].normal_tex >= 0).any():
        raise NotImplementedError(f"normal-mapped materials; see {_NORMAL_MAP_ITEM}")
    atlas = {name: np.array(arrays[f"textures.{name}"])
             for name in _ATLAS_ARRAYS if f"textures.{name}" in arrays}
    if "combined" in atlas:
        atlas["combined"] = atlas["combined"].view(np.int32)
    atlas = {name: torch.from_numpy(value) for name, value in atlas.items()}
    mats = groups["materials"]
    data = SceneData(
        textures=TextureAtlas(**atlas, any_base=bool((mats.base_color_tex >= 0).any()),
                              any_spec=bool((mats.specular_tex >= 0).any()),
                              any_emissive=bool((mats.emissive_tex >= 0).any())),
        env_map=torch.from_numpy(env.copy()), **groups,
    )
    return BakedScene.build(data, build(TriSoA, "tris"), device)
