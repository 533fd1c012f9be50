"""The wavefront frame as CUDA graphs (`pipeline/graphs.py`): on the CPU,
the device-valued inputs a capture reads (a frame index as an int64
tensor, the camera and jitter as tensors) give the eager wavefront's bits,
and a stage's span is a capture's split; `cuda`-marked cases replay the
graphs on the card."""
from dataclasses import replace

import numpy as np
import pytest
import torch

from fyp_bidirectionalpathtracer_tpu_torch import cuda
from fyp_bidirectionalpathtracer_tpu_torch.core import rng
from fyp_bidirectionalpathtracer_tpu_torch.models.procedural import cornell_box, icosphere
from fyp_bidirectionalpathtracer_tpu_torch.pipeline import graphs
from fyp_bidirectionalpathtracer_tpu_torch.pipeline.renderer import (
    BDPT_FRAME_INIT,
    GBUF_FRAME_INIT,
    Renderer,
)
from fyp_bidirectionalpathtracer_tpu_torch.passes.gbuffer import pixel_jitter_for_frame
from fyp_bidirectionalpathtracer_tpu_torch.scene.camera import project_dir_to_pixel
from fyp_bidirectionalpathtracer_tpu_torch.scene.scene import Scene
from fyp_bidirectionalpathtracer_tpu_torch.utils import profiler
from fyp_bidirectionalpathtracer_tpu_torch.utils.config import RenderConfig
from fyp_bidirectionalpathtracer_tpu_torch.utils.profiler import Profiler, span
from torch_threads import one_intra_op_thread  # noqa: F401

POSES = [((0.0, 0.5, -1.3), (0.0, 0.5, 0.0)), ((0.05, 0.5, -1.3), (0.0, 0.45, 0.0))]


def _baked(width, height, device):
    """Cornell with a 5,120-triangle icosphere: the wavefront route on the
    BVH tier."""
    built = cornell_box()
    built.meshes.append(icosphere((0.5, 0.35, 0.45), 0.2, 0, subdivisions=4))
    baked = Scene.from_built(built, aspect=width / height).bake(device=device)
    assert baked.n_tris > 2048
    return baked


@pytest.mark.parametrize("frame", [0, 7, 2**31 + 5, 2**32 - 1])
def test_a_frame_index_tensor_gives_the_same_seeds(frame):
    want = rng.pixel_seeds(12, 5, frame, row0=2, sub_height=3)
    got = rng.pixel_seeds(12, 5, torch.tensor(frame, dtype=torch.int64), row0=2, sub_height=3)
    assert torch.equal(got, want)


def test_the_projection_of_tensor_values_is_the_float_values_one():
    """`project_dir_to_pixel` reads the camera and the jitter as scalar
    tensors: the pixels of the same values as Python floats."""
    cam = _baked(32, 18, "cpu").data.camera
    d = torch.randn(500, 3, generator=torch.Generator().manual_seed(3))
    d = d / torch.linalg.norm(d, dim=-1, keepdim=True)
    jit = pixel_jitter_for_frame(5)

    def vdot(b):
        return d[..., 0] * float(b[0]) + d[..., 1] * float(b[1]) + d[..., 2] * float(b[2])

    def vdot3(v):
        return float(v[0] * v[0] + v[1] * v[1] + v[2] * v[2])

    d3 = vdot(cam.camera_w) / vdot3(cam.camera_w)
    px = (((vdot(cam.camera_u) / vdot3(cam.camera_u)) / d3) * 0.5 + 0.5) * 32.0 - float(jit[0])
    py = ((-(vdot(cam.camera_v) / vdot3(cam.camera_v)) / d3) * 0.5 + 0.5) * 18.0 - float(jit[1])
    ix, iy = project_dir_to_pixel(cam, d, (32, 18), jit)
    assert torch.equal(ix, torch.round(px).to(torch.int32))
    assert torch.equal(iy, torch.round(py).to(torch.int32))


def test_a_stage_span_is_the_capture_s_split_while_one_captures():
    seen = []

    def split(name):
        seen.append(name)
        return profiler._OFF

    with profiler.splitting(split, ("subpaths",)):
        assert span("subpaths") is profiler._OFF and span("trace") is profiler._OFF
        with profiler.splitting(split, ("shadows",)):
            span("shadows")
            span("subpaths")
        span("subpaths")
    assert seen == ["subpaths", "shadows", "subpaths"]
    assert profiler._split is None and profiler._stages == ()
    assert not profiler.recording()
    with Profiler(enabled=True, wait=False):
        assert profiler.recording()


def test_the_first_frame_from_device_values_is_the_eager_frame():
    """`WavefrontGraphs`' first frame renders from its buffers (the camera
    and jitter as tensors, the frame indices as an int64 tensor): the
    channels and the BDPT image of the eager wavefront, bit for bit, with
    the same spans."""
    cfg = RenderConfig(width=16, height=12)
    baked = _baked(16, 12, "cpu")
    camera = Renderer(baked, cfg).camera
    i = 41
    args = ((GBUF_FRAME_INIT + i) & 0xFFFFFFFF, (BDPT_FRAME_INIT + i) & 0xFFFFFFFF)
    jitter = pixel_jitter_for_frame(args[1], cfg.gbuffer.jitter_mode)
    want = Profiler(enabled=True, wait=False)
    r = Renderer(baked, cfg, graphs=False)
    r.state.frame_index = i
    with want:
        r.render_frame()
    got_prof = Profiler(enabled=True, wait=False)
    g = graphs.WavefrontGraphs()
    with got_prof:
        with got_prof.event("frame"):
            got_channels, image = g.frame(baked, camera, *args, jitter, cfg, got_prof)
    assert not g.captured
    np.testing.assert_array_equal(image.numpy(), r.channels["BDPT"].numpy())
    for key, value in got_channels.items():
        np.testing.assert_array_equal(value.numpy(), r.channels[key].numpy(), key)
    spans = {k for k in want.events if k.startswith("frame/gbuffer") or k.startswith("frame/bdpt")}
    assert spans == set(got_prof.events) - {"frame"}


def test_inputs_hold_the_camera_jitter_and_frames():
    baked = _baked(16, 12, "cpu")
    camera = Renderer(baked, RenderConfig(width=16, height=12)).camera
    inputs = graphs._Inputs(camera, torch.device("cpu"))
    moved = replace(camera, pos_w=camera.pos_w + 1.0)
    inputs.upload(moved, torch.tensor([0.25, 0.75]), 3, 2**32 - 2)
    for name in inputs.names:
        assert torch.equal(getattr(inputs.camera, name), getattr(moved, name)), name
    assert inputs.jitter.tolist() == [0.25, 0.75]
    assert (int(inputs.gbuf_frame), int(inputs.bdpt_frame)) == (3, 2**32 - 2)


# ------------------------------------------------------------------ the card
def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


@pytest.mark.cuda
def test_replayed_frames_are_the_frames_rendered_from_the_same_values():
    """A renderer's frames through its graphs (captured at its second
    frame, replayed after, a camera move between) against each frame
    rendered as the first frame of a fresh `WavefrontGraphs` from the same
    values: the same BDPT image and channels, bit for bit; the channels
    handed out are copies."""
    _card()
    cfg = RenderConfig(width=128, height=72)
    baked = _baked(128, 72, "cuda")
    r = Renderer(baked, cfg)
    for k in range(5):
        if k == 3:
            r.set_camera_pose(*POSES[1])
        i = r.state.frame_index
        camera = r.camera
        r.render_frame()
        args = ((GBUF_FRAME_INIT + i) & 0xFFFFFFFF, (BDPT_FRAME_INIT + i) & 0xFFFFFFFF)
        jitter = pixel_jitter_for_frame(args[1], cfg.gbuffer.jitter_mode)
        channels, image = graphs.WavefrontGraphs().frame(baked, camera, *args, jitter, cfg,
                                                         profiler.Profiler(enabled=False))
        assert torch.equal(r.channels["BDPT"], image), k
        for key, value in channels.items():
            assert torch.equal(r.channels[key], value), (k, key)
    g = r._step.keywords["graphs"]
    assert g.captured
    assert all(r.channels[key].data_ptr() != v.data_ptr() for key, v in g._channels.items())


@pytest.mark.cuda
def test_a_replayed_frame_times_its_stages_and_reads_the_device_once():
    """A replayed frame: the stages' spans around their graphs, one host
    read (the splat's live count), the launches and rays that the capture
    counted, and close to the eager wavefront's image."""
    _card()
    cfg = RenderConfig(width=128, height=72)
    baked = _baked(128, 72, "cuda")
    r, eager = Renderer(baked, cfg), Renderer(baked, cfg, graphs=False)
    for _ in range(3):
        r.render_frame()
        eager.render_frame()
    assert r._step.keywords["graphs"].captured
    torch.cuda.synchronize()
    cuda.reset_launch_counts()
    with Profiler(enabled=True, wait=False) as prof:
        r.render_frame()
    torch.cuda.synchronize()
    n = 128 * 72
    assert cuda.READS["host_reads"] == 1
    assert cuda.LAUNCHES["bvh_shaded"] == 6 and cuda.LAUNCHES["bvh_occluded"] == 3
    assert cuda.LAUNCHES["compact"] == 1
    assert cuda.RAYS == {"bvh_closest": 0, "bvh_shaded": 6 * n, "bvh_occluded": 10 * n}
    eager.render_frame()
    assert {"frame/bdpt/subpaths", "frame/bdpt/shadows"} <= set(prof.events)
    assert not any(k.endswith("/trace") for k in prof.events)
    diff = (r.channels["Accumulated"] - eager.channels["Accumulated"]).abs().mean()
    assert float(diff) < 1e-4
