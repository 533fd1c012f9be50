"""The `tetra` scene of Eric Haines's Standard Procedural Databases (IEEE
CG&A 7(11), 1987): a Sierpinski tetrahedron of triangles alone.

The tetrahedron whose corners are (1, 1, 1), (-1, -1, 1), (-1, 1, -1) and
(1, -1, -1) (the points (+-1, +-1, +-1) with an even number of minus
signs), scaled by `size` / 2 about `center`, is replaced by its four
half-size corner tetrahedra, `depth` times.  Each of the 4^depth
tetrahedra left gives its four faces, wound outwards (the normal of
(v1 - v0) x (v2 - v0) points away from the tetrahedron's centre): one mesh
of 4^(depth + 1) triangles, three vertices of its own each, flat normals,
of material `material`.  The four faces of tetrahedron k are triangles
4k .. 4k + 3.
"""
import numpy as np

CORNERS = np.asarray([[1, 1, 1], [-1, -1, 1], [-1, 1, -1], [1, -1, -1]], np.float64)
FACES = np.asarray([[0, 1, 2], [0, 3, 1], [0, 2, 3], [1, 3, 2]])


def build(params: dict) -> list:
    depth = int(params["depth"])
    centers = np.asarray([params.get("center", (0.0, 0.0, 0.0))], np.float64)
    half = 0.5 * float(params.get("size", 2.0))
    for _ in range(depth):
        half *= 0.5
        centers = (centers[:, None, :] + CORNERS[None] * half).reshape(-1, 3)
    corners = centers[:, None, :] + CORNERS[None] * half           # [N, 4, 3]
    tri = corners[:, FACES]                                         # [N, 4, 3, 3]
    n = np.cross(tri[..., 1, :] - tri[..., 0, :], tri[..., 2, :] - tri[..., 0, :])
    outward = (n * (tri[..., 0, :] - centers[:, None, :])).sum(-1) > 0
    tri = np.where(outward[..., None, None], tri, tri[..., [0, 2, 1], :]).reshape(-1, 3, 3)
    n = np.cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0])
    n = n / np.linalg.norm(n, axis=1, keepdims=True)
    k = tri.shape[0]
    return [{"positions": tri.reshape(-1, 3).astype(np.float32),
             "normals": np.repeat(n, 3, axis=0).astype(np.float32),
             "uvs": np.zeros((3 * k, 2), np.float32),
             "indices": np.arange(3 * k, dtype=np.int32).reshape(k, 3),
             "material": int(params.get("material", 0)), "name": "tetra"}]
