"""Alpha-tested transparency: the bake-time check.

Port of `has_alpha_materials` (`fyp_bidirectionalpathtracer_tpu/ops/
alpha.py:23-39`).  The masked restart loops that trace past failed alpha
tests (the rest of that module) are ROADMAP Queue 1 item 10b; the bake
raises on a scene for which this check is true.
"""
from __future__ import annotations

import numpy as np


def has_alpha_materials(materials, atlas) -> bool:
    """Can any hit in this scene fail the alpha test?  True if some
    material's base colour (its texture's least texel alpha if textured,
    else its constant alpha) is below its threshold."""
    thr = np.asarray(materials.alpha_threshold)
    bc = np.asarray(materials.base_color)
    bc_tex = np.asarray(materials.base_color_tex)
    data = np.asarray(atlas.data)
    for m in range(thr.shape[0]):
        a_min = float(data[bc_tex[m], ..., 3].min()) if bc_tex[m] >= 0 else float(bc[m, 3])
        if a_min < thr[m]:
            return True
    return False
