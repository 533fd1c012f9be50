"""Minimal binary-FBX static-mesh importer and writer (host-side, stdlib
and numpy).

The port's own copy of `fyp_bidirectionalpathtracer_tpu/models/fbx.py`,
line for line, so that the port imports nothing of the JAX package and a
file written by either package reads the same in the other
(`tests/test_torch_scene_io.py`).  The reference imports pink_room.fbx
through Assimp (Falcor Graphics/Model/Loaders/AssimpModelImporter.cpp);
this covers the static subset the BDPT app consumes:

  * FBX binary container, versions 7100-7700 (32-bit node records below
    7500, 64-bit from 7500 on), zlib-compressed and raw array properties
  * Objects/Geometry: Vertices, PolygonVertexIndex (any polygon size, fan
    triangulated), LayerElementNormal / LayerElementUV / LayerElementMaterial
    with MappingInformationType ByPolygonVertex | ByVertex/ByVertice |
    ByPolygon | AllSame and ReferenceInformationType Direct | IndexToDirect
  * Objects/Model: Lcl Translation / Rotation (XYZ Euler, degrees) /
    Scaling + PreRotation, composed through OO Model->Model connection
    chains (the full FBX pivot/offset stack is not reproduced)
  * Objects/Material (FbxSurfacePhong subset): DiffuseColor, SpecularColor,
    EmissiveColor, Shininess, Opacity -> MaterialDesc (spec-gloss, as
    Falcor's Assimp path fills Material, AssimpModelImporter.cpp
    createMaterial)
  * Connections: OO geometry->model and material->model wiring; ByPolygon
    material layers split meshes per attached material like Assimp's
    per-material mesh split

`save_fbx` writes the same subset (one Geometry/Model per mesh, version
7400 or 7500).  ASCII FBX is out of scope.
"""
from __future__ import annotations

import struct
import zlib
from dataclasses import dataclass, field

import numpy as np

from .procedural import MaterialDesc, MeshData

_MAGIC = b"Kaydara FBX Binary  \x00\x1a\x00"


# =================================================================== reader
@dataclass
class FBXNode:
    name: str
    props: list
    children: list = field(default_factory=list)

    def child(self, name: str):
        for c in self.children:
            if c.name == name:
                return c
        return None

    def all(self, name: str):
        return [c for c in self.children if c.name == name]


_SCALAR = {"Y": ("<h", 2), "C": ("<B", 1), "I": ("<i", 4),
           "F": ("<f", 4), "D": ("<d", 8), "L": ("<q", 8)}
_ARRAY = {"f": np.dtype("<f4"), "d": np.dtype("<f8"),
          "l": np.dtype("<i8"), "i": np.dtype("<i4"), "b": np.dtype("<u1")}


def _read_prop(buf: bytes, off: int):
    t = chr(buf[off])
    off += 1
    if t in _SCALAR:
        fmt, n = _SCALAR[t]
        v = struct.unpack_from(fmt, buf, off)[0]
        return (bool(v) if t == "C" else v), off + n
    if t in _ARRAY:
        n, enc, clen = struct.unpack_from("<III", buf, off)
        off += 12
        dt = _ARRAY[t]
        if enc == 0:
            raw = buf[off:off + n * dt.itemsize]
            off += n * dt.itemsize
        elif enc == 1:
            raw = zlib.decompress(buf[off:off + clen])
            off += clen
        else:
            raise ValueError(f"unknown FBX array encoding {enc}")
        return np.frombuffer(raw, dt, count=n), off
    if t in ("S", "R"):
        n = struct.unpack_from("<I", buf, off)[0]
        off += 4
        raw = buf[off:off + n]
        return (raw.decode("utf-8", "replace") if t == "S" else raw), off + n
    raise ValueError(f"unknown FBX property type {t!r}")


def _read_node(buf: bytes, off: int, wide: bool):
    """Returns (FBXNode | None, next_offset); None = null sentinel."""
    if wide:
        end, n_props, plen = struct.unpack_from("<QQQ", buf, off)
        off += 24
    else:
        end, n_props, plen = struct.unpack_from("<III", buf, off)
        off += 12
    name_len = buf[off]
    off += 1
    if end == 0 and n_props == 0 and name_len == 0:
        return None, off
    name = buf[off:off + name_len].decode("ascii", "replace")
    off += name_len
    props = []
    for _ in range(n_props):
        v, off = _read_prop(buf, off)
        props.append(v)
    node = FBXNode(name, props)
    while off < end:
        child, off = _read_node(buf, off, wide)
        if child is None:
            break
        node.children.append(child)
    return node, end


def parse_fbx(path: str) -> tuple[FBXNode, int]:
    """Parse the node tree; returns (virtual root, version)."""
    with open(path, "rb") as fh:
        buf = fh.read()
    if buf[:len(_MAGIC)] != _MAGIC:
        raise ValueError(f"{path}: not a binary FBX file")
    version = struct.unpack_from("<I", buf, len(_MAGIC))[0]
    wide = version >= 7500
    off = len(_MAGIC) + 4
    root = FBXNode("", [])
    sentinel = 25 if wide else 13
    while off + sentinel <= len(buf):
        node, off = _read_node(buf, off, wide)
        if node is None:
            break
        root.children.append(node)
    return root, version


# ----------------------------------------------------------- scene assembly
def _props70(node: FBXNode) -> dict:
    out = {}
    p70 = node.child("Properties70")
    if p70 is not None:
        for p in p70.all("P"):
            out[p.props[0]] = p.props[4:]
    return out


def _euler_xyz_deg(rot) -> np.ndarray:
    rx, ry, rz = (np.deg2rad(float(a)) for a in rot)
    cx, sx = np.cos(rx), np.sin(rx)
    cy, sy = np.cos(ry), np.sin(ry)
    cz, sz = np.cos(rz), np.sin(rz)
    mx = np.asarray([[1, 0, 0], [0, cx, -sx], [0, sx, cx]])
    my = np.asarray([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]])
    mz = np.asarray([[cz, -sz, 0], [sz, cz, 0], [0, 0, 1]])
    return (mz @ my @ mx).astype(np.float64)  # eEulerXYZ: X applied first


def _model_local(model: FBXNode) -> np.ndarray:
    p = _props70(model)
    m = np.eye(4)
    r = _euler_xyz_deg(p.get("Lcl Rotation", (0.0, 0.0, 0.0)))
    pre = _euler_xyz_deg(p.get("PreRotation", (0.0, 0.0, 0.0)))
    s = np.asarray(p.get("Lcl Scaling", (1.0, 1.0, 1.0)), np.float64)
    m[:3, :3] = pre @ r * s[None, :]
    m[:3, 3] = np.asarray(p.get("Lcl Translation", (0.0, 0.0, 0.0)))
    return m


def _layer_lookup(layer: FBXNode, data_name: str, index_name: str,
                  n_polyvert: int, polyvert_to_vert, polyvert_to_poly,
                  width: int) -> np.ndarray | None:
    """Resolve a LayerElement* to one row per polygon-vertex."""
    if layer is None:
        return None
    data = layer.child(data_name)
    if data is None:
        return None
    arr = np.asarray(data.props[0], np.float64).reshape(-1, width)
    mapping = ""
    ref = "Direct"
    mi = layer.child("MappingInformationType")
    if mi is not None:
        mapping = mi.props[0]
    ri = layer.child("ReferenceInformationType")
    if ri is not None:
        ref = ri.props[0]
    idx_node = layer.child(index_name)
    if ref == "IndexToDirect" and idx_node is not None:
        lut = np.asarray(idx_node.props[0], np.int64)
    else:
        lut = None

    if mapping == "ByPolygonVertex":
        sel = np.arange(n_polyvert)
    elif mapping in ("ByVertex", "ByVertice"):
        sel = polyvert_to_vert
    elif mapping == "ByPolygon":
        sel = polyvert_to_poly
    elif mapping == "AllSame":
        sel = np.zeros(n_polyvert, np.int64)
    else:  # unknown mapping: best effort per polygon-vertex
        sel = np.minimum(np.arange(n_polyvert), len(arr) - 1)
    if lut is not None:
        sel = lut[np.minimum(sel, len(lut) - 1)]
    return arr[np.minimum(sel, len(arr) - 1)].astype(np.float32)


def _material_desc(mat_node: FBXNode) -> MaterialDesc:
    p = _props70(mat_node)
    name = mat_node.props[1].split("\x00")[0] if len(mat_node.props) > 1 else ""
    kd = p.get("DiffuseColor", (0.8, 0.8, 0.8))
    ks = p.get("SpecularColor", (0.0, 0.0, 0.0))
    ke = p.get("EmissiveColor", (0.0, 0.0, 0.0))
    shin = float(p.get("Shininess", (0.0,))[0]) if "Shininess" in p else 0.0
    opacity = float(p.get("Opacity", (1.0,))[0]) if "Opacity" in p else 1.0
    gloss = min(1.0, float(np.sqrt(max(shin, 0.0) / 1000.0)))
    return MaterialDesc(
        name=name or "fbx",
        base_color=(float(kd[0]), float(kd[1]), float(kd[2]), opacity),
        specular=(float(ks[0]), float(ks[1]), float(ks[2]), gloss),
        emissive=(float(ke[0]), float(ke[1]), float(ke[2])),
    )


def load_fbx(path: str):
    """Load a binary FBX. Returns (meshes: list[MeshData],
    materials: list[MaterialDesc]) — same contract as obj.load_obj;
    positions/normals are in world space (model transforms applied)."""
    root, _version = parse_fbx(path)
    objects = root.child("Objects")
    if objects is None:
        return [], [MaterialDesc()]

    geoms: dict[int, FBXNode] = {}
    models: dict[int, FBXNode] = {}
    mats: dict[int, FBXNode] = {}
    for n in objects.children:
        if not n.props or not isinstance(n.props[0], int):
            continue
        uid = n.props[0]
        if n.name == "Geometry":
            geoms[uid] = n
        elif n.name == "Model":
            models[uid] = n
        elif n.name == "Material":
            mats[uid] = n

    parent_of: dict[int, int] = {}          # OO child -> parent
    children_of: dict[int, list[int]] = {}  # OO parent -> [child]
    conns = root.child("Connections")
    if conns is not None:
        for c in conns.all("C"):
            if len(c.props) >= 3 and c.props[0] == "OO":
                child, parent = int(c.props[1]), int(c.props[2])
                parent_of[child] = parent
                children_of.setdefault(parent, []).append(child)

    def world(model_uid: int) -> np.ndarray:
        m = np.eye(4)
        uid, depth = model_uid, 0
        while uid in models and depth < 64:
            m = _model_local(models[uid]) @ m
            uid = parent_of.get(uid, 0)
            depth += 1
        return m

    materials: list[MaterialDesc] = [MaterialDesc()]
    mat_slot: dict[int, int] = {}

    def mat_index(uid: int) -> int:
        if uid not in mat_slot:
            mat_slot[uid] = len(materials)
            materials.append(_material_desc(mats[uid]))
        return mat_slot[uid]

    meshes: list[MeshData] = []
    for guid, geo in geoms.items():
        verts_node = geo.child("Vertices")
        poly_node = geo.child("PolygonVertexIndex")
        if verts_node is None or poly_node is None:
            continue
        verts = np.asarray(verts_node.props[0], np.float64).reshape(-1, 3)
        raw_idx = np.asarray(poly_node.props[0], np.int64)

        # polygon-vertex table: vertex id per corner + polygon id per corner
        corner_vert = np.where(raw_idx < 0, ~raw_idx, raw_idx)
        poly_end = raw_idx < 0
        corner_poly = np.concatenate([[0], np.cumsum(poly_end)[:-1]])
        n_pv = len(raw_idx)

        normals_pv = _layer_lookup(
            geo.child("LayerElementNormal"), "Normals", "NormalsIndex",
            n_pv, corner_vert, corner_poly, 3)
        uv_pv = _layer_lookup(
            geo.child("LayerElementUV"), "UV", "UVIndex",
            n_pv, corner_vert, corner_poly, 2)

        # per-polygon material slot (into the model's connected materials)
        mat_layer = geo.child("LayerElementMaterial")
        poly_mat = None
        if mat_layer is not None and mat_layer.child("Materials") is not None:
            marr = np.asarray(mat_layer.child("Materials").props[0], np.int64)
            mm = mat_layer.child("MappingInformationType")
            if mm is not None and mm.props[0] == "ByPolygon":
                poly_mat = marr
            else:  # AllSame
                poly_mat = np.full(int(corner_poly[-1]) + 1 if n_pv else 1,
                                   marr[0] if len(marr) else 0, np.int64)

        # model transform + attached material list
        model_uid = parent_of.get(guid, 0)
        xform = world(model_uid) if model_uid in models else np.eye(4)
        rot = xform[:3, :3]
        inv_t = np.linalg.inv(rot).T if abs(np.linalg.det(rot)) > 1e-12 \
            else np.eye(3)
        attached = [u for u in children_of.get(model_uid, []) if u in mats]

        # fan-triangulate, bucketed per material slot
        starts = np.concatenate([[0], np.nonzero(poly_end)[0] + 1])
        ends = np.concatenate([np.nonzero(poly_end)[0] + 1, [n_pv]])
        buckets: dict[int, list] = {}
        for pi, (s0, e0) in enumerate(zip(starts, ends)):
            if e0 - s0 < 3:
                continue
            slot = int(poly_mat[min(pi, len(poly_mat) - 1)]) \
                if poly_mat is not None and len(poly_mat) else 0
            tris = buckets.setdefault(slot, [])
            for k in range(s0 + 1, e0 - 1):
                tris.append((s0, k, k + 1))

        for slot, tris in buckets.items():
            pv = np.asarray(tris, np.int64).reshape(-1)   # corner ids
            pos = verts[corner_vert[pv]]
            pos = pos @ rot.T + xform[:3, 3]
            if normals_pv is not None:
                nrm = normals_pv[pv].astype(np.float64) @ inv_t.T
            else:
                p3 = pos.reshape(-1, 3, 3)
                fn = np.cross(p3[:, 1] - p3[:, 0], p3[:, 2] - p3[:, 0])
                fn /= np.linalg.norm(fn, axis=1, keepdims=True) + 1e-20
                nrm = np.repeat(fn, 3, axis=0)
            nrm = nrm / (np.linalg.norm(nrm, axis=1, keepdims=True) + 1e-20)
            uv = (uv_pv[pv] if uv_pv is not None
                  else np.zeros((len(pv), 2), np.float32))
            idx = np.arange(len(pv), dtype=np.int32).reshape(-1, 3)
            mat_id = (mat_index(attached[slot])
                      if slot < len(attached) else 0)
            meshes.append(MeshData(
                pos.astype(np.float32), nrm.astype(np.float32),
                uv.astype(np.float32), idx, mat_id))
    return meshes, materials


# =================================================================== writer
def _emit_prop(out: bytearray, v):
    if isinstance(v, bool):
        out += b"C" + struct.pack("<B", int(v))
    elif isinstance(v, int):
        out += b"L" + struct.pack("<q", v)
    elif isinstance(v, float):
        out += b"D" + struct.pack("<d", v)
    elif isinstance(v, str):
        raw = v.encode()
        out += b"S" + struct.pack("<I", len(raw)) + raw
    elif isinstance(v, bytes):
        out += b"R" + struct.pack("<I", len(v)) + v
    elif isinstance(v, np.ndarray):
        code = {"f4": b"f", "f8": b"d", "i4": b"i", "i8": b"l",
                "u1": b"b"}[v.dtype.str[1:]]
        raw = v.tobytes()
        comp = zlib.compress(raw)
        if len(comp) < len(raw):  # exercise both encodings in round-trips
            out += code + struct.pack("<III", v.size, 1, len(comp)) + comp
        else:
            out += code + struct.pack("<III", v.size, 0, len(raw)) + raw
    else:
        raise TypeError(f"cannot emit FBX property {type(v)}")


def _render_tree(node: FBXNode, abs_off: int, wide: bool) -> bytes:
    props = bytearray()
    for p in node.props:
        _emit_prop(props, p)
    name = node.name.encode("ascii")
    hdr_len = (24 if wide else 12) + 1 + len(name)
    out = bytearray()
    body_off = abs_off + hdr_len + len(props)
    body = bytearray()
    cur = body_off
    for c in node.children:
        blob = _render_tree(c, cur, wide)
        body += blob
        cur += len(blob)
    if node.children:
        body += bytes(25 if wide else 13)
        cur += 25 if wide else 13
    end = cur
    fmt = "<QQQ" if wide else "<III"
    out += struct.pack(fmt, end, len(node.props), len(props))
    out += struct.pack("<B", len(name)) + name + props + body
    return bytes(out)


def save_fbx(path: str, meshes: list, materials: list,
             version: int = 7400) -> None:
    """Write the minimal static-mesh subset load_fbx reads back."""
    wide = version >= 7500
    objects = FBXNode("Objects", [])
    conns = FBXNode("Connections", [])
    uid = 1000

    def p70(entries):
        n = FBXNode("Properties70", [])
        for name, typ, vals in entries:
            n.children.append(
                FBXNode("P", [name, typ, "", "A", *map(float, vals)]))
        return n

    mat_uid = {}
    for mi, m in enumerate(materials):
        uid += 1
        mat_uid[mi] = uid
        node = FBXNode("Material", [uid, f"{m.name}\x00\x01Material", ""])
        node.children.append(p70([
            ("DiffuseColor", "Color", m.base_color[:3]),
            ("SpecularColor", "Color", m.specular[:3]),
            ("EmissiveColor", "Color", m.emissive),
            ("Shininess", "double", (1000.0 * m.specular[3] ** 2,)),
            ("Opacity", "double", (m.base_color[3],)),
        ]))
        objects.children.append(node)

    for k, mesh in enumerate(meshes):
        uid += 1
        guid = uid
        uid += 1
        muid = uid
        pos = np.asarray(mesh.positions, np.float64)
        idx = np.asarray(mesh.indices, np.int64)
        pvi = idx.copy().reshape(-1, 3)
        pvi[:, 2] = ~pvi[:, 2]  # close each triangle polygon
        nrm = np.asarray(mesh.normals, np.float64)[idx.reshape(-1)]
        uv = np.asarray(mesh.uvs, np.float64)
        uv_vals, uv_idx = np.unique(uv[idx.reshape(-1)], axis=0,
                                    return_inverse=True)
        geo = FBXNode("Geometry", [guid, f"mesh{k}\x00\x01Geometry", "Mesh"])
        geo.children.append(FBXNode("Vertices", [pos.reshape(-1)]))
        geo.children.append(
            FBXNode("PolygonVertexIndex", [pvi.reshape(-1)]))
        ln = FBXNode("LayerElementNormal", [0])
        ln.children.append(
            FBXNode("MappingInformationType", ["ByPolygonVertex"]))
        ln.children.append(FBXNode("ReferenceInformationType", ["Direct"]))
        ln.children.append(FBXNode("Normals", [nrm.reshape(-1)]))
        geo.children.append(ln)
        lu = FBXNode("LayerElementUV", [0])
        lu.children.append(
            FBXNode("MappingInformationType", ["ByPolygonVertex"]))
        lu.children.append(
            FBXNode("ReferenceInformationType", ["IndexToDirect"]))
        lu.children.append(FBXNode("UV", [uv_vals.reshape(-1)]))
        lu.children.append(FBXNode("UVIndex", [uv_idx.astype(np.int64)]))
        geo.children.append(lu)
        lm = FBXNode("LayerElementMaterial", [0])
        lm.children.append(FBXNode("MappingInformationType", ["AllSame"]))
        lm.children.append(
            FBXNode("ReferenceInformationType", ["IndexToDirect"]))
        lm.children.append(FBXNode("Materials", [np.zeros(1, np.int64)]))
        geo.children.append(lm)
        objects.children.append(geo)

        model = FBXNode("Model", [muid, f"mesh{k}\x00\x01Model", "Mesh"])
        model.children.append(p70([]))
        objects.children.append(model)
        conns.children.append(FBXNode("C", ["OO", guid, muid]))
        conns.children.append(FBXNode("C", ["OO", muid, 0]))
        conns.children.append(
            FBXNode("C", ["OO", mat_uid.get(mesh.material, mat_uid[0]),
                          muid]))

    buf = bytearray()
    buf += _MAGIC + struct.pack("<I", version)
    off = len(buf)
    for top in (objects, conns):
        blob = _render_tree(top, off, wide)
        buf += blob
        off += len(blob)
    buf += bytes(25 if wide else 13)
    # FBX footer: 16 opaque bytes + padding + version echo + 120 zero bytes
    # + magic footer id; readers (including this one) stop at the null
    # sentinel, so emit the simple canonical tail
    buf += bytes(16)
    with open(path, "wb") as fh:
        fh.write(bytes(buf))
