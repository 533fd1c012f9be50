"""Row sharding of a frame over ranks, one process and one device each.

Port of `fyp_bidirectionalpathtracer_tpu/parallel/sharding.py`.  The
strategy is JAX's: rendering is independent per pixel, so the [H, W] image
splits by rows over a 1-D mesh (`ROW_AXIS`).  Every rank bakes the whole
scene (the tables are read-only).  The one interaction a frame is
estimator 2's light-tracing splat (BDPTMain.rt.hlsl:199 writes any pixel):
each rank reduces its splats into a full-size image, the images are summed
over the ranks, and each keeps its rows.  The accumulation and the BMFR
history shard with the image; BMFR exchanges row halos
(`passes/bmfr.bmfr_pass`).

Where JAX runs one SPMD program over the devices of a `Mesh`, the port
runs one process a rank: `launch(fn, n)` starts `n` ranks on this host and
each calls `fn(rank, mesh, ...)` with its `RowMesh`.  Each rank runs the
port's CUDA kernels on its own rows: K1 with its shard's pixel offset, K2,
the sort and K3 (or K5) into the full splat image, or the K4 and BVH
kernels on its rows' wavefront batches.

The process group's backend follows one rule: `nccl` when every rank has
a card of its own, `gloo` when ranks share a card (NCCL refuses two ranks
on one device) or run on the CPU; `launch(..., backend=)` overrides it.
Under gloo, CUDA tensors take part only in `all_reduce` and `broadcast`,
so `RowMesh` builds every collective from `all_reduce`: a row gather and
a halo exchange are sums of a zeroed [ranks, ...] slot buffer in which
each rank fills its own slot.  They sum the values' int32 bits, so what
arrives is bit for bit what was sent (-0.0 and NaN included); the same
code runs under nccl.
"""
from __future__ import annotations

import functools
import os
import shutil
import sys
import tempfile
from dataclasses import dataclass

import torch
import torch.distributed as dist

from .. import cuda

ROW_AXIS = "rows"


@dataclass(frozen=True)
class RowMesh:
    """The row mesh: `size` ranks, rank r rendering rows [r * H / size,
    (r + 1) * H / size) of an H-row image on `device`.  `backend` is the
    process group's (None for a one-rank mesh, which has no group)."""

    size: int
    rank: int
    device: torch.device
    backend: str | None = None

    def row_range(self, height: int) -> tuple[int, int]:
        """(row0, sub_height) of this rank's rows of an image `height` rows
        high."""
        if height % self.size:
            raise ValueError(f"row sharding needs a height divisible by {self.size} "
                             f"(got {height})")
        sub_h = height // self.size
        return self.rank * sub_h, sub_h

    def shard_rows(self, x):
        """This rank's rows of an image-shaped array or tensor [H, ...]
        (JAX `shard_image_tree` for one leaf)."""
        row0, sub_h = self.row_range(x.shape[0])
        return x[row0:row0 + sub_h]

    def all_reduce(self, x: torch.Tensor) -> torch.Tensor:
        """The sum of `x` over the ranks, in place."""
        if self.size > 1:
            dist.all_reduce(x)
        return x

    def gather_rows(self, x: torch.Tensor) -> torch.Tensor:
        """Every rank's `x` [sub_h, ...] stacked by rank into [size * sub_h,
        ...], bit for bit, on every rank (JAX `replicate_tree` of a
        row-sharded leaf)."""
        if self.size == 1:
            return x
        bits = _bits(x)
        slots = torch.zeros((self.size,) + tuple(bits.shape), dtype=torch.int32,
                            device=bits.device)
        slots[self.rank] = bits
        dist.all_reduce(slots)
        return slots.reshape((-1,) + tuple(bits.shape[1:])).view(x.dtype)

    def exchange_rows(self, first: torch.Tensor, last: torch.Tensor):
        """Each rank hands its `first` rows to the rank above and its `last`
        rows to the rank below.  Returns (the rank above's `last`, the rank
        below's `first`), None at the image's top and bottom edges."""
        a, b = _bits(first).reshape(-1), _bits(last).reshape(-1)
        slots = torch.zeros((self.size, a.numel() + b.numel()), dtype=torch.int32,
                            device=a.device)
        slots[self.rank, :a.numel()] = a
        slots[self.rank, a.numel():] = b
        self.all_reduce(slots)
        above = below = None
        if self.rank > 0:
            above = slots[self.rank - 1, a.numel():].reshape(last.shape).view(last.dtype)
        if self.rank < self.size - 1:
            below = slots[self.rank + 1, :a.numel()].reshape(first.shape).view(first.dtype)
        return above, below


def _bits(x: torch.Tensor) -> torch.Tensor:
    if x.dtype not in (torch.float32, torch.int32):
        raise TypeError(f"row collectives take float32 or int32 tensors, got {x.dtype}")
    return x.contiguous().view(torch.int32)


def make_mesh(n_devices: int | None = None, device="cuda") -> RowMesh:
    """The row mesh of this process's group (the ranks `launch` started),
    or a one-rank mesh where no group is initialised.  The rank's device
    is the card of its rank (cuda:rank modulo the host's cards) unless
    `device` names an index or another type (device='cpu')."""
    if dist.is_available() and dist.is_initialized():
        size, rank, backend = dist.get_world_size(), dist.get_rank(), dist.get_backend()
    else:
        size, rank, backend = 1, 0, None
    if n_devices is not None and n_devices != size:
        raise ValueError(f"a mesh of {n_devices} ranks asked for in a group of {size}; "
                         f"start the ranks with sharding.launch")
    dev = cuda.resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", rank % torch.cuda.device_count())
    return RowMesh(size=size, rank=rank, device=dev, backend=backend)


def _rank_devices(n: int, device: torch.device) -> list:
    """The device of each of n ranks: the CPU, the named card, or the
    host's cards in turn."""
    if device.type != "cuda" or device.index is not None:
        return [str(device)] * n
    count = torch.cuda.device_count()
    return [f"cuda:{r % count}" for r in range(n)]


def choose_backend(devices: list) -> str:
    """nccl when every rank has a card of its own, gloo otherwise."""
    own_cards = all(d.startswith("cuda") for d in devices) and len(set(devices)) == len(devices)
    return "nccl" if own_cards else "gloo"


def _rank_main(rank, fn, n, init_method, backend, devices, out_dir, args):
    dev = torch.device(devices[rank])
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    else:  # the ranks share the host's cores
        torch.set_num_threads(max(1, torch.get_num_threads() // n))
    dist.init_process_group(backend, init_method=init_method, world_size=n, rank=rank)
    try:
        result = fn(rank, make_mesh(n, dev), *args)
        torch.save(result, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def launch(fn, n: int, *args, device="cuda", backend: str | None = None) -> list:
    """Run `fn(rank, mesh, *args)` on `n` ranks of this host, one spawned
    process each, and return their results by rank (what `torch.save`
    writes; tensors come back on the CPU).

    Ranks run on the card unless `device` names another (device='cpu'
    runs them on the CPU, where the kernels' plain versions run).  The
    kernels are built here, once, before the ranks start, so that no two
    ranks build them.  The ranks meet at a `file://` rendezvous in a fresh
    temporary folder, so launches running side by side never share a
    port.  `backend` overrides the rule of `choose_backend`; a backend
    that fails to start raises."""
    if n < 1:
        raise ValueError(f"launch needs at least one rank, got {n}")
    dev = cuda.resolve_device(device)
    if dev.type == "cuda":
        cuda.library()
    devices = _rank_devices(n, dev)
    backend = backend or choose_backend(devices)
    print(f"sharding.launch: {n} ranks on {', '.join(devices)}, backend {backend}",
          file=sys.stderr, flush=True)
    tmp = tempfile.mkdtemp(prefix="bdpt_ranks_")
    try:
        torch.multiprocessing.start_processes(
            _rank_main, args=(fn, n, f"file://{tmp}/rendezvous", backend, devices, tmp, args),
            nprocs=n, join=True, start_method="spawn")
        return [torch.load(os.path.join(tmp, f"rank{r}.pt"), map_location="cpu",
                           weights_only=False) for r in range(n)]
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def sharded_megakernel_step(cfg, mesh: RowMesh):
    """The render step of this rank's rows through the frame megakernel
    (JAX `sharded_megakernel_step`): K1 on the shard's pixels with their
    global ids, so the shard draws the single-device frame's RNG
    sequences; the estimator-2 splat image summed over the mesh inside
    `accel/frame.render_frame_megakernel`; BMFR per shard with row halos.
    Returns step(baked, camera, accum, bmfr, gbuf_frame, bdpt_frame,
    reset) -> (channels, accum, bmfr) over the rank's rows.

    JAX also needs each shard's pixel count to be a multiple of 128 (its
    kernel's lanes); the port's K1 runs one thread a pixel and takes any
    count, so only the height must divide by the ranks."""
    from ..pipeline.renderer import render_frame_fn

    mesh.row_range(cfg.height)  # the ranks divide the height
    return functools.partial(render_frame_fn, cfg=cfg, mesh=mesh, megakernel=True)


def sharded_wavefront_step(cfg, mesh: RowMesh):
    """The render step of this rank's rows through the per-bounce wavefront
    (JAX `sharded_wavefront_step`): the G-buffer and BDPT passes on the
    rank's rows with global pixel ids (`ray_traced_gbuffer(row0=,
    sub_height=)`, `bdpt_pass(full_height=, row0=, mesh=)`), every batch
    through the K4 or BVH kernels, the estimator-2 splat summed over the
    mesh; BMFR per shard with row halos.  Same step signature as
    `sharded_megakernel_step`."""
    from ..pipeline.renderer import render_frame_fn

    mesh.row_range(cfg.height)  # the ranks divide the height
    return functools.partial(render_frame_fn, cfg=cfg, mesh=mesh, megakernel=False)
