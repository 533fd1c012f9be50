"""A configuration's scene as the reference reads it, and its camera.

`Scene.of(arrays, device)` takes the dict of `scenes.load_arrays` (meshes
in world space, materials, lights, camera) and keeps, a triangle each, its
corners, vertex normals and the decoded material: diffuse, specular,
alpha (the squared linear roughness, at least 0.08 before the square),
emissive, opacity and whether it is double-sided (simplePrepareShadingData,
BDPTUtils.hlsli:2-52: metal-rough or spec-gloss).  Textured materials are
not read: the reference renders untextured configurations only.

It also splits the triangles into groups of at most `GROUP` by the
textbook median split (halve a set at the median centroid along the axis
where the centroids spread most, until a set is small enough), each group
with its float64 box and its longest edge, which the ray queries
(`bdpt.closest`, `bdpt.blocked`) use to skip the groups a ray cannot hit.

`Camera.at(camera, pose, aspect)` is Falcor's camera at a pose
(Camera.cpp:64-140): the U/V/W frame the rays are built from and the
unjittered view-projection matrix.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import torch

METAL_ROUGH = 0
LIGHT_DIRECTIONAL = 1
GROUP = 128          # the most triangles a group holds


@dataclass
class Scene:
    v0: torch.Tensor       # [T, 3]
    e1: torch.Tensor
    e2: torch.Tensor
    n0: torch.Tensor
    n1: torch.Tensor
    n2: torch.Tensor
    diffuse: torch.Tensor  # [T, 3]
    specular: torch.Tensor
    alpha: torch.Tensor    # [T]
    emissive: torch.Tensor  # [T, 3]
    opacity: torch.Tensor  # [T]
    two_sided: torch.Tensor  # [T] bool
    light_pos: torch.Tensor  # [L, 3]
    light_dir: torch.Tensor  # [L, 3] unit
    light_power: torch.Tensor  # [L, 3]
    light_directional: torch.Tensor  # [L] bool
    env: torch.Tensor      # [3], the constant environment
    groups: torch.Tensor   # [G, L] triangle indices a group, ascending, padded with the first
    box_lo: torch.Tensor   # [G, 3] each group's box, float64
    box_hi: torch.Tensor
    box_edge: torch.Tensor  # [G] the longest edge of a group's triangles, float64
    scale: float           # the largest coordinate in magnitude

    @classmethod
    def of(cls, arrays: dict, device, dtype=torch.float64) -> "Scene":
        def t(x):
            return torch.as_tensor(x, dtype=dtype, device=device)

        corners, normals, mats = [], [], []
        for mesh in arrays["meshes"]:
            idx = torch.as_tensor(mesh["indices"], dtype=torch.int64).reshape(-1, 3)
            corners.append(t(mesh["positions"])[idx])
            normals.append(t(mesh["normals"])[idx])
            mats += [mesh["material"]] * idx.shape[0]
        p, n = torch.cat(corners), torch.cat(normals)
        groups, lo, hi, edge = split(p.detach().to("cpu", torch.float64))
        rows = [_material(m) for m in arrays["materials"]]
        if any(m.get(k) is not None for m in arrays["materials"]
               for k in ("base_color_image", "specular_image", "emissive_image")):
            raise ValueError("the reference renders untextured configurations only")
        pick = [rows[k] for k in mats]
        lights = arrays["lights"]
        dirs = []
        for light in lights:
            d = [float(x) for x in light.get("dir", (0.0, -1.0, 0.0))]
            norm = math.sqrt(sum(x * x for x in d))
            dirs.append([x / norm for x in d] if norm > 0 else d)
        return cls(
            v0=p[:, 0], e1=p[:, 1] - p[:, 0], e2=p[:, 2] - p[:, 0],
            n0=n[:, 0], n1=n[:, 1], n2=n[:, 2],
            diffuse=t([r["diffuse"] for r in pick]), specular=t([r["specular"] for r in pick]),
            alpha=t([r["alpha"] for r in pick]), emissive=t([r["emissive"] for r in pick]),
            opacity=t([r["opacity"] for r in pick]),
            two_sided=torch.tensor([r["two_sided"] for r in pick], device=device),
            light_pos=t([light.get("pos", (0.0, 0.0, 0.0)) for light in lights]),
            light_dir=t(dirs),
            light_power=t([light.get("intensity", (1.0, 1.0, 1.0)) for light in lights]),
            light_directional=torch.tensor(
                [light.get("type", "point") in ("dir", "dir_light", "directional")
                 for light in lights], device=device),
            env=t(arrays.get("env", (0.0, 0.0, 0.0))),
            groups=groups.to(device), box_lo=lo.to(device), box_hi=hi.to(device),
            box_edge=edge.to(device), scale=float(p.abs().max()) if p.numel() else 0.0)

    @property
    def n_lights(self) -> int:
        return int(self.light_pos.shape[0])


def split(p: torch.Tensor, size: int = GROUP):
    """Groups of the triangles with corners p [T, 3, 3] (float64, on the
    host): ([G, L] indices, each row ascending and padded with its first,
    L the largest group; [G, 3] box corners low and high; [G] the longest
    edge of a group's triangles).

    A set of more than `size` triangles is halved at the median of its
    centroids along the axis of their widest spread, ties kept in index
    order.  Each box holds its triangles' corners, in float64 whatever the
    scene's type."""
    centroid = p.mean(1)
    todo, leaves = [torch.arange(p.shape[0])], []
    while todo:
        idx = todo.pop()
        if idx.numel() <= size:
            leaves.append(idx.sort().values)
            continue
        c = centroid[idx]
        axis = int((c.amax(0) - c.amin(0)).argmax())
        order = torch.argsort(c[:, axis], stable=True)
        half = idx.numel() // 2
        todo += [idx[order[half:]], idx[order[:half]]]
    width = max(leaf.numel() for leaf in leaves)
    groups = torch.stack([torch.cat([leaf, leaf[:1].expand(width - leaf.numel())])
                          for leaf in leaves])
    corners = p[groups].reshape(len(leaves), -1, 3)
    edges = torch.cat([p[:, 1] - p[:, 0], p[:, 2] - p[:, 0], p[:, 2] - p[:, 1]], 1)
    longest = torch.linalg.vector_norm(edges.reshape(-1, 3, 3), dim=2).amax(1)[groups].amax(1)
    return groups, corners.amin(1), corners.amax(1), longest


def _material(m: dict) -> dict:
    base = [float(x) for x in m["base_color"]]
    spec = [float(x) for x in m.get("specular", (0.0, 0.0, 0.0, 0.0))]
    if int(m.get("shading_model", METAL_ROUGH)) == METAL_ROUGH:
        metal = spec[2]
        diffuse = [c * (1.0 - metal) for c in base[:3]]
        specular = [0.04 * (1.0 - metal) + c * metal for c in base[:3]]
        linear = spec[1]
    else:
        diffuse, specular, linear = base[:3], spec[:3], 1.0 - spec[3]
    linear = max(0.08, linear)
    return {"diffuse": diffuse, "specular": specular, "alpha": linear * linear,
            "emissive": [float(x) for x in m.get("emissive", (0.0, 0.0, 0.0))],
            "opacity": base[3], "two_sided": bool(m.get("double_sided", False))}


@dataclass
class Camera:
    pos: torch.Tensor      # [3]
    u: torch.Tensor        # [3] right, scaled to the image plane's half width
    v: torch.Tensor        # [3] up, scaled to its half height
    w: torch.Tensor        # [3] forward, scaled by the focal distance
    view_proj: torch.Tensor  # [4, 4], column vectors

    @classmethod
    def at(cls, camera: dict, pose, aspect: float, device, dtype=torch.float64) -> "Camera":
        pos, target, up = (torch.tensor([float(x) for x in v], dtype=dtype, device=device)
                           for v in pose)
        focal = float(camera.get("focal_length", 21.0))
        frame_h = float(camera.get("frame_height", 24.0))
        near = float(camera.get("near_z", 0.1))
        far = float(camera.get("far_z", 1000.0))
        dist = float(camera.get("focal_distance", 10000.0))
        fov_y = 2.0 * math.atan(0.5 * frame_h / focal)
        half = math.tan(0.5 * fov_y)
        fwd = _unit(target - pos)
        right = _unit(torch.linalg.cross(fwd, up))
        upv = _unit(torch.linalg.cross(right, fwd))
        # glm lookAt (right-handed) and perspectiveRH_ZO
        view = torch.eye(4, dtype=dtype, device=device)
        view[0, :3], view[1, :3], view[2, :3] = right, upv, -fwd
        view[0, 3], view[1, 3], view[2, 3] = -(right @ pos), -(upv @ pos), fwd @ pos
        proj = torch.zeros((4, 4), dtype=dtype, device=device)
        proj[0, 0], proj[1, 1] = 1.0 / (half * aspect), 1.0 / half
        proj[2, 2], proj[2, 3] = far / (near - far), far * near / (near - far)
        proj[3, 2] = -1.0
        return cls(pos=pos, u=right * dist * half * aspect, v=upv * dist * half,
                   w=fwd * dist, view_proj=proj @ view)


def _unit(x: torch.Tensor) -> torch.Tensor:
    return x / torch.linalg.vector_norm(x)
