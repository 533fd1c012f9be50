"""The JAX package's numpy-only modules that the port uses as they are.

None of them imports jax: the render configuration dataclasses
(`fyp_bidirectionalpathtracer_tpu/utils/config.py`) and the procedural
scene builders (`fyp_bidirectionalpathtracer_tpu/models/procedural.py`).
Scene bakes also call `accel/bvh.build_bvh` from there (see
`scene/scene.py`), so both packages order triangles the same way.
"""
from fyp_bidirectionalpathtracer_tpu.models.procedural import (  # noqa: F401
    BuiltScene,
    MaterialDesc,
    MeshData,
    cornell_box,
    icosphere,
    many_light_scene,
)
from fyp_bidirectionalpathtracer_tpu.utils.config import (  # noqa: F401
    AccumulateConfig,
    BDPTConfig,
    BMFRConfig,
    GBufferConfig,
    RenderConfig,
)
