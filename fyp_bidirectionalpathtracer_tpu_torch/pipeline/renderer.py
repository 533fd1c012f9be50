"""The rendering pipeline (the RenderingPipeline/Sample analogue).

Port of `fyp_bidirectionalpathtracer_tpu/pipeline/renderer.py`:
`render_frame_fn`, `Renderer`, `GBUF_FRAME_INIT`, `BDPT_FRAME_INIT`, with
the same signatures and channel dict.  The pass list is
G-buffer + BDPT -> est-2 splat reduction -> accumulation -> BMFR (a blit
of Accumulated while disabled, the reference's default; enabled, the
preprocess, regression and postprocess of `passes/bmfr.py` on the frame's
device).

Routing: megakernel 'auto' and 'on' run the frame program for a scene in
its gate, as the kernel K1 on a CUDA device and as its plain version on
CPU tensors (JAX's interpret-mode megakernel plays that role on the CPU);
a base-colour-textured scene with `defer_textures=True` is in the gate and
runs K1's textured variant and the deferred-texture replay.  megakernel
'off', and a scene the gate refuses (other textures, normal maps,
deferral off, alpha-tested materials, an env map larger than 1x1, or
above 2048 triangles), run the per-bounce wavefront (JAX `renderer.py:
91-117`): `ray_traced_gbuffer`, then `bdpt_pass`, every trace through the
dense K4 intersectors or, above 2048 triangles, the BVH kernels, in the
alpha restarts of `ops/alpha.py` where the scene has alpha-tested
materials.  On the card, a `Renderer`'s whole-image wavefront frames run
as CUDA graphs from its second such frame on (`pipeline/graphs.
WavefrontGraphs`).  `Renderer.display` tone-maps with any of the 7
operators of `ops/tonemap.py`.  `Renderer.render_frame_profiled` is the same frame
with each pass timed by a `utils/profiler.Profiler` event; the camera,
the display and the layers under the passes are `utils/profiler` spans;
`set_camera_pose` moves the camera (the checkpoint's resume calls it);
`Renderer.animate` advances the bake's camera and object paths (JAX
`renderer.py:183-205`) and bakes the host scene again on the renderer's
device whenever an object path posed a mesh or a light.

`Renderer(baked, cfg, mesh=)` renders this rank's rows of a frame split
by rows over the ranks of a `parallel/sharding.RowMesh` (JAX `renderer.py:
134-166`): the megakernel step where the gate admits the scene, else the
wavefront step, each with BMFR's halo mode when BMFR is on.  JAX sends a
BMFR-on frame to an XLA-partitioned plain frame instead; the port has no
partitioner and runs the per-shard kernels there too (ROADMAP Queue 3).
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from functools import partial

import numpy as np
import torch

from ..accel.frame import render_frame_megakernel, supports_megakernel
from ..ops import tonemap as tonemap_mod
from ..passes.accumulate import AccumState, accumulate, camera_moved
from ..passes.bdpt import bdpt_pass
from ..passes.bmfr import BMFRState, bmfr_pass
from ..passes.gbuffer import pixel_jitter_for_frame
from ..scene.camera import begin_frame, derive_camera
from ..scene.scene import BakedScene
from ..utils.config import RenderConfig
from ..utils.profiler import Profiler, span
from . import graphs as graphs_mod

GBUF_FRAME_INIT = 0xDEADBEEF   # LightProbeGBufferPass seed origin
BDPT_FRAME_INIT = 0x1337       # BDPTPass.h:40
_NO_PROFILE = Profiler(enabled=False)


@dataclass
class RenderState:
    """Everything mutable across frames."""

    accum: AccumState
    bmfr: BMFRState
    frame_index: int = 0
    time: float = 0.0


def render_frame_fn(baked: BakedScene, camera, accum: AccumState, bmfr_state,
                    gbuf_frame: int, bdpt_frame: int, reset: bool,
                    cfg: RenderConfig, prof: Profiler | None = None, mesh=None,
                    megakernel: bool | None = None, graphs=None):
    """One full frame.  Returns (channels, accum, bmfr_state).  A bake with
    `plain=True` runs every kernel's plain version on its device.

    `mesh` (a `parallel/sharding.RowMesh`) renders this rank's rows: the
    channels, `accum` and `bmfr_state` are the rank's rows of the frame.
    `megakernel` forces the route (True: the frame megakernel, which the
    gate must admit; False: the wavefront); None routes by the config and
    the gate.  `graphs` (a `pipeline/graphs.WavefrontGraphs`) renders a
    whole-image wavefront frame of a bake on the card through CUDA graphs.

    `prof`, an enabled `utils/profiler.Profiler`, times the frame a pass at
    a time (the RenderingPipeline ProfilerEvent-per-pass analogue,
    RenderingPipeline.cpp:666-682): `frame`, then `megakernel` or `gbuffer`
    + `bdpt`, then `accumulate` and `bmfr`, each waiting for its outputs on
    the device before its end time (with its `wait`).  The waits are its
    only cost: the work and its order are the same with or without it.
    The passes are spans of the same tracer (`utils/profiler`) with or
    without `prof`, so a running `torch.profiler` sees them too."""
    prof = _NO_PROFILE if prof is None else prof
    scene = baked.with_camera(camera)
    jitter = pixel_jitter_for_frame(bdpt_frame, cfg.gbuffer.jitter_mode)
    row0, sub_h = (0, cfg.height) if mesh is None else mesh.row_range(cfg.height)
    gate = supports_megakernel(scene, cfg)
    if megakernel is None:
        megakernel = cfg.bdpt.megakernel != "off" and gate
    elif megakernel and not gate:
        raise ValueError("the megakernel step needs a scene the megakernel gate admits")
    with prof.event("frame") as frame_h:
        if megakernel:
            with prof.event("megakernel") as h:
                channels, frame_img = render_frame_megakernel(
                    scene, cfg.width, cfg.height, bdpt_frame, jitter, cfg,
                    gbuf_frame=gbuf_frame, sub_height=sub_h, pixel_offset=row0 * cfg.width,
                    mesh=mesh)
                h[0] = frame_img
        elif graphs is not None and mesh is None and baked.device.type == "cuda" \
                and not baked.plain:
            channels, frame_img = graphs.frame(baked, camera, gbuf_frame, bdpt_frame, jitter,
                                               cfg, prof)
            channels["BDPT"] = frame_img
        else:
            trace, intersect = graphs_mod.tracers(scene, cfg)
            with prof.event("gbuffer") as h:
                channels = graphs_mod.gbuffer(scene, trace, cfg, gbuf_frame, jitter,
                                              row0=row0, sub_height=sub_h)
                h[0] = channels
            with prof.event("bdpt") as h:
                frame_img = bdpt_pass(scene, intersect, channels, bdpt_frame, jitter, cfg.bdpt,
                                      trace=trace, full_height=cfg.height, row0=row0,
                                      mesh=mesh)
                h[0] = frame_img
            channels["BDPT"] = frame_img
        with prof.event("accumulate") as h:
            accum, accum_img = accumulate(accum, frame_img,
                                          cfg.accumulate.max_accum_count, reset=reset)
            h[0] = accum_img
        channels["Accumulated"] = accum_img
        with prof.event("bmfr") as h:
            bmfr_state, denoised = bmfr_pass(bmfr_state, channels, camera, cfg.bmfr, mesh=mesh)
            h[0] = denoised
        channels["PipelineOutput"] = denoised
        frame_h[0] = denoised
    return channels, accum, bmfr_state


class Renderer:
    """Progressive renderer over a baked scene, on the scene's device.

    With `mesh` (a `parallel/sharding.RowMesh`; the bake on the rank's
    device), this rank's rows: the state, the channels and `render_frame`'s
    result are the rank's [H / ranks, W, 4] rows, and `display` gathers the
    whole image (a collective: every rank calls it).  `graphs=False` keeps
    the wavefront frames off CUDA graphs."""

    def __init__(self, baked: BakedScene, config: RenderConfig, mesh=None,
                 graphs: bool = True):
        self.baked = baked
        self.cfg = config
        self.mesh = mesh
        self.camera = derive_camera(replace(
            baked.data.camera,
            aspect=torch.tensor(config.width / config.height, dtype=torch.float32)))
        dev = baked.device
        rows = config.height
        if mesh is None:
            self._step = partial(render_frame_fn, cfg=config,
                                 graphs=graphs_mod.WavefrontGraphs() if graphs else None)
        else:
            from ..parallel import sharding

            rows = mesh.row_range(config.height)[1]
            if config.bdpt.megakernel != "off" and supports_megakernel(baked, config):
                # per-rank K1 + the splat image summed over the ranks
                self._step = sharding.sharded_megakernel_step(config, mesh)
            else:
                # per-rank wavefront with the K4 / BVH kernels
                self._step = sharding.sharded_wavefront_step(config, mesh)
        self.state = RenderState(
            accum=AccumState.create(rows, config.width, dev),
            bmfr=BMFRState.create(rows, config.width, dev))
        self._prev_view_proj = self.camera.view_proj
        self.channels: dict = {}

    # -- camera control ------------------------------------------------
    def set_camera_pose(self, pos, target, up=(0, 1, 0)):
        """Move the camera (host float32 tensors, as CameraData keeps them)
        and roll prevViewProj; the next frame resets the accumulation."""
        with span("camera"):
            self.camera = begin_frame(replace(
                self.camera, pos_w=_host_f32(pos), target=_host_f32(target), up=_host_f32(up)))

    def animate(self, dt: float):
        """Advance the active camera path and any object paths (Scene::update,
        Scene.cpp:106-125): `state.time` grows by dt * camera_speed, the
        first camera path poses the camera, and when the host scene posed a
        mesh or a light (`Scene.update_objects`) it is baked again on this
        renderer's device with the same light capacity, the camera kept.
        As in JAX, the accumulation resets on a camera move only
        (`camera_moved` compares view_proj): an object path alone keeps
        accumulating."""
        host = self.baked.host
        advanced = False
        if host.camera_paths:
            self.state.time += dt * host.camera_speed
            advanced = True
            pos, tgt, up = host.camera_paths[0].sample(self.state.time)
            self.set_camera_pose(pos, tgt, up)
        if host.object_paths:
            if not advanced:
                self.state.time += dt * host.camera_speed
            if host.update_objects(self.state.time):
                # geometry moved: bake again (the DXR BLAS-refit analogue);
                # the old bake's tables are dropped with it
                self.baked = replace(
                    host.bake(max_lights=int(self.baked.data.lights.pos_w.shape[0]),
                              device=self.baked.device),
                    plain=self.baked.plain)

    # -- frame loop ------------------------------------------------------
    def render_frame(self, prof: Profiler | None = None):
        with span("camera"):
            reset = camera_moved(self._prev_view_proj, self.camera.view_proj)
        i = self.state.frame_index
        self.channels, self.state.accum, self.state.bmfr = self._step(
            self.baked, self.camera, self.state.accum, self.state.bmfr,
            (GBUF_FRAME_INIT + i) & 0xFFFFFFFF, (BDPT_FRAME_INIT + i) & 0xFFFFFFFF,
            reset, prof=prof)
        self.state.frame_index += 1
        self._prev_view_proj = self.camera.view_proj
        # roll prevViewProj for the next frame's reprojection
        with span("camera"):
            self.camera = begin_frame(self.camera)
        return self.channels["PipelineOutput"]

    def render_frame_profiled(self, prof: Profiler):
        """`render_frame` with a Profiler event a pass (`render_frame_fn`),
        `prof` active over the whole frame: the camera's spans and those
        under the passes report to it too, without waits."""
        with prof:
            return self.render_frame(prof)

    def render(self, n_frames: int):
        out = None
        for _ in range(n_frames):
            out = self.render_frame()
        return out

    def display(self, channel: str = "PipelineOutput"):
        """Tone-mapped image (the SimpleToneMappingPass analogue), by the
        configured operator; on a mesh, of the whole image gathered from
        every rank's rows (some operators take the frame's mean)."""
        with span("display"):
            op = tonemap_mod.OPERATOR_NAMES[self.cfg.tone_map_operator]
            img = self.channels[channel]
            if self.mesh is not None:
                img = self.mesh.gather_rows(img)
            return tonemap_mod.tone_map(img[..., :3], op)


def _host_f32(x) -> torch.Tensor:
    """A float32 CPU tensor of a sequence, array or tensor (copied)."""
    if isinstance(x, torch.Tensor):
        return x.detach().to(device="cpu", dtype=torch.float32).clone()
    return torch.tensor(np.asarray(x, np.float32))


def make_cornell_renderer(size: int = 256, device="cuda", **cfg_kw) -> Renderer:
    """Convenience: a size x size Cornell-box renderer (BASELINE config 1),
    on the card unless `device` names another."""
    from ..models.procedural import cornell_box
    from ..scene.scene import Scene

    cfg = RenderConfig(width=size, height=size, **cfg_kw)
    baked = Scene.from_built(cornell_box(), aspect=1.0).bake(device=device)
    return Renderer(baked, cfg)
