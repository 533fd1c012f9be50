"""The pink_room flagship interior (reference: pink_room.fscene:1-274).

The port's own copy of `fyp_bidirectionalpathtracer_tpu/models/
pink_room.py`, so that the port imports nothing of the JAX package;
`tests/test_torch_textured.py` holds the two to equal scenes.  Textures
decode without PIL (`utils/image.read_rgba`, PIL's `convert("RGBA")` bit
for bit, PNG and JPEG alike); `asset_dir=""` builds procedural checkerboard
textures.  `asset_dir=None` finds the reference textures where the
environment variable `PINK_ROOM_TEXTURES` names their folder.

The reference renders `pink_room.fbx` — a packman-fetched binary asset that
is NOT in its repository — so exact mesh parity is impossible anywhere.
What IS in the reference repo: the .fscene (lights/camera/path, parsed by
scene.fscene) and 27 textures (src/CommonPasses/Data/pink_room/textures).
This module authors a faithful-scale furnished living room in the fscene's
coordinate frame (camera path and lights land inside it) and maps every one
of those textures through the atlas; when the texture directory is absent
the materials fall back to procedural stand-ins so the scene stays
self-contained.

Geometry: walls/floor/ceiling, rug, three-seat sofa with cushions and legs,
glass coffee table, vase with twigs, fruit bowl, two wall pictures, a
curtain, and emissive light fixtures at the .fscene's two point lights —
10-50k triangles depending on `subdivisions`.
"""
from __future__ import annotations

import os

import numpy as np

from ..utils.image import DECODE_ERRORS, read_rgba
from .procedural import (
    BuiltScene,
    MaterialDesc,
    MeshData,
    box,
    checkerboard,
    icosphere,
    quad,
)

# the reference's texture folder (src/CommonPasses/Data/pink_room/textures),
# where the environment names a checkout of it; the JAX module looks in a
# fixed place instead
REFERENCE_TEXTURE_DIR = os.environ.get("PINK_ROOM_TEXTURES", "")

# fscene frame: the room interior holds the camera path (x in [-5,0],
# y in [0,2.4], z in [-4,0]) and both point lights.
X0, X1 = -5.6, 0.4
Y0, Y1 = 0.0, 2.7
Z0, Z1 = -4.6, 1.4


def _load_texture(asset_dir, name, fallback):
    """PNG/JPG -> [h,w,4] float32 in [0,1]; `fallback` when the file is
    missing or corrupt (JAX's PIL loader falls back on any failure; a file
    PIL reads and the port does not raises, naming its reason)."""
    if asset_dir:
        path = os.path.join(asset_dir, name)
        if os.path.exists(path):
            try:
                return read_rgba(path)
            except DECODE_ERRORS:  # a corrupt asset
                pass
    return fallback


def _translate(mesh: MeshData, t) -> MeshData:
    return MeshData(
        mesh.positions + np.asarray(t, np.float32),
        mesh.normals, mesh.uvs, mesh.indices, mesh.material,
    )


def _scaled_sphere(center, radii, material, subdivisions):
    """Ellipsoid from an icosphere (normals recomputed for the scaling)."""
    m = icosphere((0, 0, 0), 1.0, material, subdivisions=subdivisions)
    r = np.asarray(radii, np.float32)
    pos = m.positions * r + np.asarray(center, np.float32)
    nrm = m.normals / np.maximum(r, 1e-9)
    nrm = nrm / (np.linalg.norm(nrm, axis=1, keepdims=True) + 1e-20)
    return MeshData(pos.astype(np.float32), nrm.astype(np.float32),
                    m.uvs, m.indices, material)


def pink_room(
    asset_dir: str | None = None,
    subdivisions: int = 3,
    use_fscene_lights: bool = True,
) -> BuiltScene:
    """Build the furnished room.  asset_dir=None auto-detects the reference
    texture directory; pass "" to force procedural fallbacks."""
    if asset_dir is None and os.path.isdir(REFERENCE_TEXTURE_DIR):
        asset_dir = REFERENCE_TEXTURE_DIR

    def tex(name, c0, c1, tiles=4):
        return _load_texture(asset_dir, name, checkerboard(64, c0, c1, tiles))

    def mat(name, base, basename=None, specname=None, emisname=None,
            spec=(0.04, 0.04, 0.04, 0.6), emissive=(0, 0, 0),
            double_sided=False):
        kw = {}
        if basename:
            kw["base_color_image"] = tex(
                basename, tuple(base[:3]),
                tuple(0.6 * np.asarray(base[:3])),
            )
        if specname:
            kw["specular_image"] = tex(specname, spec[:3], spec[:3])
        if emisname:
            kw["emissive_image"] = tex(emisname, emissive, emissive, 1)
        return MaterialDesc(
            name, base_color=tuple(base), specular=tuple(spec),
            emissive=tuple(emissive), double_sided=double_sided, **kw
        )

    materials = [
        mat("walls", (0.92, 0.62, 0.62, 1.0), "Walls_BaseColor.png",
            "Walls_Specular.png"),                                      # 0
        mat("white_paint", (0.92, 0.92, 0.9, 1.0),
            "WhitePaint_BaseColor.png", "WhitePaint_Specular.png"),     # 1
        mat("wood_floor", (0.55, 0.38, 0.24, 1.0), None,
            "WoodFloor_Specular.png", spec=(0.2, 0.17, 0.12, 0.8)),     # 2
        mat("rug", (0.8, 0.75, 0.7, 1.0), "Rug_BaseColor.png",
            "Rug_Specular.png"),                                        # 3
        mat("sofa", (0.85, 0.5, 0.52, 1.0), "Sofa_BaseColor.png",
            "Sofa_Specular.png"),                                       # 4
        mat("cushions", (0.8, 0.72, 0.6, 1.0), "Cushions_BaseColor.png",
            "Cushions_Specular.png"),                                   # 5
        mat("legs", (0.25, 0.18, 0.12, 1.0), "Legs_BaseColor.png",
            "Legs_Specular.png", spec=(0.3, 0.3, 0.3, 0.85)),           # 6
        mat("glass", (0.7, 0.75, 0.78, 1.0), "Glass_BaseColor.png",
            "Glass_Specular.png", spec=(0.5, 0.5, 0.5, 0.95)),          # 7
        mat("vase", (0.7, 0.74, 0.8, 1.0), "Vase_BaseColor.png",
            "Vase_Specular.png", spec=(0.4, 0.4, 0.4, 0.9)),            # 8
        mat("twigs", (0.4, 0.3, 0.2, 1.0), "Twigs_BaseColor.png",
            "Twigs_Specular.png"),                                      # 9
        mat("fruits", (0.8, 0.6, 0.2, 1.0), "Fruits_BaseColor.png",
            "Fruits_Specular.png"),                                     # 10
        mat("picture", (0.9, 0.9, 0.9, 1.0), "Picture_BaseColor.png",
            "Picture_Specular.png"),                                    # 11
        mat("abstract", (0.8, 0.8, 0.8, 1.0), "Abstract.jpg", None),    # 12
        mat("fabric", (0.75, 0.72, 0.78, 1.0), "Fabric.jpg", None,
            double_sided=True),                                         # 13
        mat("light_fixture", (0.9, 0.88, 0.8, 1.0), "Light_BaseColor.png",
            "Light_Specular.png", emisname="Light_Emissive.png",
            emissive=(3.0, 2.8, 2.4)),                                  # 14
    ]

    s = BuiltScene(materials=materials)
    add = s.meshes.append

    # ---- shell (interior-facing windings like procedural.cornell_box) ----
    add(quad((X0, Y0, Z0), (X0, Y0, Z1), (X1, Y0, Z1), (X1, Y0, Z0), 2,
             uv_scale=3.0))                                     # floor
    add(quad((X0, Y1, Z0), (X1, Y1, Z0), (X1, Y1, Z1), (X0, Y1, Z1), 1,
             uv_scale=2.0))                                     # ceiling
    add(quad((X0, Y0, Z1), (X0, Y1, Z1), (X1, Y1, Z1), (X1, Y0, Z1), 0,
             uv_scale=2.0))                                     # back (+z)
    add(quad((X1, Y0, Z0), (X1, Y0, Z1), (X1, Y1, Z1), (X1, Y1, Z0), 0,
             uv_scale=2.0))                                     # right (x=X1)
    add(quad((X0, Y0, Z0), (X0, Y1, Z0), (X0, Y1, Z1), (X0, Y0, Z1), 0,
             uv_scale=2.0))                                     # left (x=X0)
    add(quad((X1, Y0, Z0), (X1, Y1, Z0), (X0, Y1, Z0), (X0, Y0, Z0), 0,
             uv_scale=2.0))                                     # front (-z)

    # ---- rug under the coffee table ----
    add(box((-2.5, 0.012, -1.5), (3.0, 0.02, 2.2), 3))

    # ---- sofa against the back wall ----
    add(box((-2.5, 0.42, 0.85), (2.6, 0.42, 0.95), 4))          # seat base
    add(box((-2.5, 0.95, 1.22), (2.6, 0.75, 0.22), 4))          # backrest
    add(box((-3.90, 0.72, 0.85), (0.24, 0.62, 0.95), 4))        # left arm
    add(box((-1.10, 0.72, 0.85), (0.24, 0.62, 0.95), 4))        # right arm
    for i, cx in enumerate((-3.25, -2.5, -1.75)):
        add(_scaled_sphere((cx, 0.80, 0.72), (0.34, 0.17, 0.30), 5,
                           subdivisions))                       # cushions
    for dx in (-3.7, -1.3):
        for dz in (0.15, 1.55):
            add(box((dx, 0.08, dz + 0.0), (0.08, 0.16, 0.08), 6))  # legs

    # ---- glass coffee table ----
    add(box((-2.5, 0.44, -1.5), (1.5, 0.05, 0.8), 7))           # top
    for dx in (-3.1, -1.9):
        for dz in (-1.8, -1.2):
            add(box((dx, 0.21, dz), (0.07, 0.42, 0.07), 6))     # legs

    # ---- vase with twigs + fruit bowl on the table ----
    add(_scaled_sphere((-2.85, 0.63, -1.62), (0.11, 0.17, 0.11), 8,
                       subdivisions))
    rs = np.random.RandomState(3)
    for k in range(6):
        ang = k * np.pi / 3 + 0.3
        tip = np.asarray([
            -2.85 + 0.13 * np.cos(ang), 1.02 + 0.06 * rs.rand(),
            -1.62 + 0.13 * np.sin(ang),
        ])
        base = np.asarray([-2.85, 0.72, -1.62])
        c = 0.5 * (tip + base)
        sz = np.abs(tip - base) + 0.015
        add(box(tuple(c), tuple(sz), 9))                        # twigs
    add(_scaled_sphere((-2.15, 0.53, -1.4), (0.16, 0.05, 0.16), 7,
                       subdivisions))                           # bowl
    for k, (dx, dz) in enumerate(((-0.05, 0.0), (0.06, 0.04), (0.0, -0.07))):
        add(_scaled_sphere((-2.15 + dx, 0.56, -1.4 + dz),
                           (0.045, 0.045, 0.045), 10, subdivisions))

    # ---- pictures + curtain ----
    add(quad((-3.4, 1.2, Z1 - 0.01), (-3.4, 2.1, Z1 - 0.01),
             (-2.2, 2.1, Z1 - 0.01), (-2.2, 1.2, Z1 - 0.01), 11))
    add(quad((-1.8, 1.3, Z1 - 0.01), (-1.8, 2.0, Z1 - 0.01),
             (-0.9, 2.0, Z1 - 0.01), (-0.9, 1.3, Z1 - 0.01), 12))
    add(quad((X0 + 0.01, 0.2, -3.8), (X0 + 0.01, 2.5, -3.8),
             (X0 + 0.01, 2.5, -2.2), (X0 + 0.01, 0.2, -2.2), 13))

    # ---- emissive fixtures at the .fscene point lights ----
    for lx, ly, lz in ((-4.645, 1.543, -1.488), (-1.016, 1.474, -1.426)):
        add(box((lx, ly + 0.22, lz), (0.22, 0.18, 0.22), 14))
        add(box((lx, ly + 0.95, lz), (0.02, 1.3, 0.02), 6))     # cord

    # ---- lights + camera from the .fscene (pink_room.fscene:50-133) ----
    if use_fscene_lights:
        s.lights = [
            {"type": "directional",
             "dir": (0.3642266, -0.5452652, 0.755),
             "intensity": (1.0, 1.0, 0.9843138)},
            {"type": "point", "pos": (-4.6454816, 1.5427508, -1.4884598),
             "intensity": (1.0, 1.0, 1.0)},
            {"type": "point", "pos": (-1.0161369, 1.4740270, -1.4256235),
             "intensity": (1.0, 1.0, 1.0)},
        ]
    s.camera = {
        "pos": (-2.7067757, 0.8529411, -3.1124387),
        "target": (-2.3472645, 0.7383298, -2.1863630),
        "up": (0.0385218, 0.9933950, 0.1079814),
        "focal_length": 21.0,
        "aspect": 16.0 / 9.0,
    }
    return s
