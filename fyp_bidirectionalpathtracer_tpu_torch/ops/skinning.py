"""Linear-blend skinning (the SkinningCache rebuild), plain torch.

Port of `fyp_bidirectionalpathtracer_tpu/ops/skinning.py`, which is plain
`jnp` (no Pallas kernel).  The reference skins meshes on the GPU through
Falcor's SkinningCache + AnimationController (Graphics/Model/
SkinningCache.cpp, Animation*.cpp): per-vertex bone ids and weights and a
per-frame bone-matrix palette give skinned positions and normals before
the BLAS refit; here the skinned vertices feed the bake (a re-bake is the
refit's analogue).  No renderer path calls it, in JAX or here; rigs are
supplied by the caller.

JAX blends the K influences through one-hot matmuls; this port gathers
each vertex's K palette rows and sums them weighted, every product an
elementwise multiply, so no TF32 matmul can reach it on the card.  The
results agree with JAX's to float32 rounding of the sums' order
(`tests/test_torch_animation.py`).
"""
from __future__ import annotations

import torch


def bone_matrices(rotations: torch.Tensor, translations: torch.Tensor) -> torch.Tensor:
    """[B, 3, 4] rigid palette from [B, 3, 3] rotations + [B, 3] offsets."""
    return torch.cat([rotations, translations[:, :, None]], dim=-1)


def skin_vertices(positions, normals, bone_ids, bone_weights, palette):
    """Linear-blend skin positions [V, 3] + normals [V, 3].

    bone_ids [V, K] integer, bone_weights [V, K] (rows sum to 1),
    palette [B, 3, 4] rigid bone transforms (rest -> posed).  Returns
    (positions, normals), the normals renormalised."""
    b = palette.shape[0]
    flat = palette.reshape(b, 12)
    # [V, K, 12] rows weighted and summed over K: the blended matrix
    m = (bone_weights[..., None] * flat[bone_ids.long()]).sum(1).reshape(-1, 3, 4)
    rot = m[:, :, :3]
    pos = (rot * positions[:, None, :]).sum(-1) + m[:, :, 3]
    nrm = (rot * normals[:, None, :]).sum(-1)
    nrm = nrm / torch.linalg.norm(nrm, dim=-1, keepdim=True).clamp(min=1e-20)
    return pos, nrm
