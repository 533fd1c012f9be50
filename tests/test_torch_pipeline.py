"""The port's Renderer against the checked-in golden, and the port's
independence from jax and from the JAX package at run time."""
import os
import subprocess
import sys

import numpy as np
import pytest

from fyp_bidirectionalpathtracer_tpu.ops.tonemap import OPERATOR_NAMES, tone_map
from fyp_bidirectionalpathtracer_tpu.utils.image import psnr, read_png, to_u8
from fyp_bidirectionalpathtracer_tpu.utils.testing import GOLDEN_DIR
from fyp_bidirectionalpathtracer_tpu_torch.pipeline.renderer import Renderer
from fyp_bidirectionalpathtracer_tpu_torch.models.procedural import cornell_box
from fyp_bidirectionalpathtracer_tpu_torch.scene.scene import Scene
from fyp_bidirectionalpathtracer_tpu_torch.utils.config import RenderConfig
from torch_threads import one_intra_op_thread  # noqa: F401

SIZE = 64
# the JAX package's golden bar (utils/testing.golden_compare)
MIN_PSNR = 38.0
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _golden_psnr(name, img) -> float:
    """golden_compare's comparison, read-only: 8-bit PSNR against the PNG."""
    golden = read_png(os.path.join(GOLDEN_DIR, f"{name}.png"))
    got = to_u8(np.clip(np.asarray(img), 0.0, 1.0)).astype(np.float32) / 255.0
    return psnr(got, golden)


@pytest.fixture(scope="module")
def renderer():
    r = Renderer(Scene.from_built(cornell_box(), aspect=1.0).bake(device="cpu"),
                 RenderConfig(width=SIZE, height=SIZE))
    r.render(8)
    return r


def test_golden_cornell_bdpt(renderer):
    """8 frames at 64x64 against tests/golden/cornell_bdpt_8f_64.png,
    tone-mapped as the JAX Renderer.display does."""
    img = renderer.channels["PipelineOutput"][..., :3].numpy()
    shown = np.asarray(tone_map(img, OPERATOR_NAMES["clamp"]))
    np.testing.assert_array_equal(shown, renderer.display().numpy())
    value = _golden_psnr("cornell_bdpt_8f_64", shown)
    assert value >= MIN_PSNR, value


def test_renderer_state_after_8_frames(renderer):
    assert renderer.state.frame_index == 8
    assert int(renderer.state.accum.count) == 8
    assert set(renderer.channels) == {
        "WorldPosition", "WorldNormal", "MaterialDiffuse", "MaterialSpecRough",
        "MaterialExtraParams", "Emissive", "BDPT", "Accumulated", "PipelineOutput"}
    for v in renderer.channels.values():
        assert v.shape == (SIZE, SIZE, 4) and bool(np.isfinite(v.numpy()).all())


def test_port_never_imports_jax():
    code = (
        "import sys\n"
        "from fyp_bidirectionalpathtracer_tpu_torch.models.procedural import cornell_box\n"
        "from fyp_bidirectionalpathtracer_tpu_torch.utils.config import RenderConfig\n"
        "from fyp_bidirectionalpathtracer_tpu_torch.scene.scene import Scene\n"
        "from fyp_bidirectionalpathtracer_tpu_torch.pipeline.renderer import Renderer\n"
        "r = Renderer(Scene.from_built(cornell_box(), aspect=1.0).bake(device='cpu'),\n"
        "             RenderConfig(width=16, height=16))\n"
        "out = r.render_frame()\n"
        "assert tuple(out.shape) == (16, 16, 4)\n"
        "assert 'jax' not in sys.modules, 'jax was imported'\n"
        "pkg = 'fyp_bidirectionalpathtracer_tpu'\n"
        "bad = [m for m in sys.modules if m == pkg or m.startswith(pkg + '.')]\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [REPO] + [p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep) if p]))
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().endswith("ok")
