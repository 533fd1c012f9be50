"""The wavefront frame as CUDA graphs.

The per-bounce wavefront (`passes/gbuffer.ray_traced_gbuffer`, then
`passes/bdpt.bdpt_pass`) launches some 6,000 device operations a frame,
each dispatched by the host, and the host's dispatch then sets the frame's
pace: the card idles most of the frame.  Up to the estimator-2 splat the
shapes are the frame's size and the configuration's, and what changes
from frame to frame enters through a few values: the camera, the
sub-pixel jitter and the two frame indices.  `WavefrontGraphs` keeps those
values in device buffers.  It renders a renderer's first wavefront frame
from them as the wavefront does, captures the next frame that no span
recorder watches (a Profiler or torch.profiler would see the capture's
spans) as CUDA graphs, and replays the graphs after that: a frame copies
the values in (two copies from pinned memory), replays the G-buffer's
graph and the BDPT pass's, then runs the splat (whose sort takes the live
updates that a host read counts), the accumulation and BMFR as before.  A
replay runs the captured operations on the same inputs: the image of the
first frame's path, bit for bit.

The BDPT pass's stages (its spans `subpaths` and `shadows`, which do not
nest) are graphs of their own, replayed inside their spans, and the
passes' events (`gbuffer`, `bdpt`) open around the replays, so the spans
time what the host does there.  The spans inside a stage (`trace`,
`sort`) run where the Python runs: up to the capture, not in a replay; a
replay adds to the counters of `cuda.py` (launches, rays) what its
capture counted.  A new bake or configuration starts again.  A replay
overwrites the graphs' outputs, so a frame hands out copies of the
G-buffer's channels.
"""
from __future__ import annotations

from contextlib import contextmanager
from dataclasses import fields, replace

import torch

from .. import cuda
from ..ops.shading import make_shaded_tracer
from ..passes.bdpt import bdpt_estimates, bdpt_splat
from ..passes.gbuffer import ray_traced_gbuffer
from ..utils import profiler
from ..utils.profiler import span

STAGES = ("subpaths", "shadows")   # the BDPT pass's spans that are graphs of their own
_COUNTERS = (cuda.LAUNCHES, cuda.LAUNCHES_BY_VARIANT, cuda.RAYS)


def gbuffer(scene, trace, cfg, frame, jitter, row0: int = 0, sub_height: int | None = None):
    """`ray_traced_gbuffer` with the configuration's G-buffer options."""
    gcfg = cfg.gbuffer
    lens_radius = gcfg.focal_length_gui / (2.0 * gcfg.f_stop) if gcfg.use_thin_lens else 0.0
    return ray_traced_gbuffer(
        scene, trace, cfg.width, cfg.height, frame, jitter, use_thin_lens=gcfg.use_thin_lens,
        lens_radius=lens_radius, focal_len=gcfg.focal_length_gui, row0=row0,
        sub_height=sub_height, env_bilinear=gcfg.env_bilinear)


def tracers(scene, cfg):
    """(trace, intersect): the wavefront's shaded tracer and intersector."""
    trace = make_shaded_tracer(scene, sort_divergent=cfg.bdpt.sort_bounces,
                               bounce_tex_mean=cfg.bdpt.bounce_tex_mean)
    return trace, scene.intersector()


class _Inputs:
    """The values that a frame changes, in device buffers: the camera's
    fields and the jitter in one float32 buffer, the G-buffer's and the
    BDPT pass's frame indices in one int64 buffer."""

    def __init__(self, camera, device):
        self.names = [f.name for f in fields(camera)]
        shapes = [getattr(camera, n).shape for n in self.names]
        sizes = [getattr(camera, n).numel() for n in self.names]
        self.floats = torch.empty(sum(sizes) + 2, dtype=torch.float32, device=device)
        self.ints = torch.empty(2, dtype=torch.int64, device=device)
        parts = self.floats[:-2].split(sizes)
        self.camera = replace(camera, **{n: p.view(shape) for n, p, shape
                                         in zip(self.names, parts, shapes)})
        self.jitter = self.floats[-2:]
        self.gbuf_frame, self.bdpt_frame = self.ints[0], self.ints[1]

    def upload(self, camera, jitter, gbuf_frame: int, bdpt_frame: int) -> None:
        floats = torch.cat([getattr(camera, n).reshape(-1) for n in self.names]
                           + [torch.as_tensor(jitter, dtype=torch.float32).reshape(-1)])
        ints = torch.tensor([gbuf_frame, bdpt_frame], dtype=torch.int64)
        if self.floats.is_cuda:  # copies that wait for nothing
            floats, ints = floats.pin_memory(), ints.pin_memory()
        self.floats.copy_(floats, non_blocking=True)
        self.ints.copy_(ints, non_blocking=True)


class _Capture:
    """The graphs of one captured call, split at its stages: (stage name
    or None, graph) in the order they run; `counts`, what the call added to
    each counter of `_COUNTERS`."""

    def __init__(self, pool):
        self.pool, self.graphs, self.counts = pool, [], []
        self._name = self._graph = None

    def _begin(self, name):
        self._name, self._graph = name, torch.cuda.CUDAGraph()
        self._graph.capture_begin(pool=self.pool)

    def _end(self):
        self._graph.capture_end()
        self.graphs.append((self._name, self._graph))

    @contextmanager
    def _split(self, name):
        self._end()
        self._begin(name)
        yield [None]
        self._end()
        self._begin(None)

    def run(self, fn):
        """fn() captured (nothing runs on the device until `replay`)."""
        before = [dict(c) for c in _COUNTERS]
        self._begin(None)
        with profiler.splitting(self._split, STAGES):
            out = fn()
        self._end()
        self.counts = [{k: c[k] - b[k] for k in c if c[k] != b[k]}
                       for c, b in zip(_COUNTERS, before)]
        return out

    def replay(self) -> None:
        for name, graph in self.graphs:
            if name is None:
                graph.replay()
            else:
                with span(name):
                    graph.replay()
        for counter, added in zip(_COUNTERS, self.counts):
            for k, n in added.items():
                counter[k] += n


class WavefrontGraphs:
    """A renderer's wavefront frames through CUDA graphs (the module doc)."""

    def __init__(self):
        self._key = None

    def frame(self, baked, camera, gbuf_frame: int, bdpt_frame: int, jitter, cfg, prof):
        """(channels, the BDPT image) of a whole-image wavefront frame on
        the card, as `render_frame_fn`'s wavefront route gives them."""
        first = self._key is None or self._key[0] is not baked or self._key[1] != cfg
        if first:
            self._start(baked, camera, cfg)
        self._inputs.upload(camera, jitter, gbuf_frame, bdpt_frame)
        if self._gbuffer is None and not first and not profiler.recording():
            self._capture(cfg)
        if self._gbuffer is None:
            with prof.event("gbuffer") as h:
                channels = h[0] = self._render_gbuffer(cfg)
            with prof.event("bdpt") as h:
                image = h[0] = bdpt_splat(self._render_bdpt(cfg, channels), cfg.bdpt)
            return channels, image
        with prof.event("gbuffer") as h:
            self._gbuffer.replay()
            h[0] = self._channels
        with prof.event("bdpt") as h:
            self._bdpt.replay()
            image = h[0] = bdpt_splat(self._estimates, cfg.bdpt)
        return {k: v.clone() for k, v in self._channels.items()}, image

    @property
    def captured(self) -> bool:
        return self._key is not None and self._gbuffer is not None

    def _start(self, baked, camera, cfg):
        self._gbuffer = self._bdpt = self._channels = self._estimates = None
        self._key = (baked, cfg)
        self._inputs = _Inputs(camera, baked.device)
        self._scene = baked.with_camera(self._inputs.camera)
        self._trace, self._intersect = tracers(self._scene, cfg)

    def _render_gbuffer(self, cfg):
        return gbuffer(self._scene, self._trace, cfg, self._inputs.gbuf_frame,
                       self._inputs.jitter)

    def _render_bdpt(self, cfg, channels):
        return bdpt_estimates(self._scene, self._intersect, channels, self._inputs.bdpt_frame,
                              self._inputs.jitter, cfg.bdpt, trace=self._trace,
                              full_height=cfg.height)

    def _capture(self, cfg):
        dev = self._scene.device
        torch.cuda.synchronize(dev)
        pool = torch.cuda.graph_pool_handle()
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        gbuffer_graphs, bdpt_graphs = _Capture(pool), _Capture(pool)
        with torch.cuda.stream(side):
            channels = gbuffer_graphs.run(lambda: self._render_gbuffer(cfg))
            estimates = bdpt_graphs.run(lambda: self._render_bdpt(cfg, channels))
        torch.cuda.current_stream(dev).wait_stream(side)
        self._gbuffer, self._bdpt = gbuffer_graphs, bdpt_graphs
        self._channels, self._estimates = channels, estimates
