"""Smoke test of the PyTorch / CUDA port on one NVIDIA GPU (an H100).

    python3 chip_smoke.py

Builds the hand-written kernels K1 (frame megakernel), K2 (splat
compaction) and K3 (splat tile reduction) from `fyp_bidirectionalpath
tracer_tpu_torch/csrc/`, holds each against its plain PyTorch version at
the main path's shapes, drives the port's main path (the Cornell box at
1280x720, depth 3, BMFR off) through `Renderer`, checks that the path went
through all three kernels and renders deterministically, and compares a
64x64 render with the checked-in golden image.

Exits nonzero on any failure and without a CUDA device.  The last line of
standard output is {"ok": true, "device": {...}}; the line before it lists
the kernels with their launch counts, errors and times.
"""
from __future__ import annotations

import json
import os
import struct
import subprocess
import sys
import time
import zlib

import numpy as np
import torch

REPO = os.path.dirname(os.path.abspath(__file__))
WIDTH, HEIGHT, DEPTH = 1280, 720, 3
RAYS_PER_PIXEL = 16      # bench.py's accounting at depth 3
LIVE_FRAC = 0.15         # est-2 live share on the Cornell frame
GOLDEN = os.path.join(REPO, "tests", "golden", "cornell_bdpt_8f_64.png")
MIN_PSNR = 38.0          # the JAX package's golden bar


def log(*a):
    print(*a, flush=True)


def time_ms(fn, iters: int, warmup: int = 1) -> float:
    """Mean ms per call on the device, by CUDA events around `iters` calls."""
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def read_png_rgb8(path: str) -> np.ndarray:
    """Minimal reader for 8-bit RGB, non-interlaced PNG -> float32 [H,W,3]
    in [0,1] (what utils.image.read_png returns for the goldens)."""
    data = open(path, "rb").read()
    if data[:8] != b"\x89PNG\r\n\x1a\n":
        raise ValueError(f"{path}: not a PNG")
    pos, idat, hdr = 8, b"", None
    while pos < len(data):
        n, typ = struct.unpack(">I", data[pos:pos + 4])[0], data[pos + 4:pos + 8]
        if typ == b"IHDR":
            hdr = struct.unpack(">IIBBBBB", data[pos + 8:pos + 21])
        elif typ == b"IDAT":
            idat += data[pos + 8:pos + 8 + n]
        pos += 12 + n
    w, h, depth, ctype, _, _, interlace = hdr
    if depth != 8 or ctype != 2 or interlace:
        raise ValueError(f"{path}: only 8-bit RGB non-interlaced PNGs are read")
    raw, stride = zlib.decompress(idat), w * 3
    out = np.zeros((h, stride), np.int64)
    prev = np.zeros(stride, np.int64)
    for y in range(h):
        f = raw[y * (stride + 1)]
        cur = np.frombuffer(raw, np.uint8, stride, y * (stride + 1) + 1).astype(np.int64)
        for x in range(stride):
            a = cur[x - 3] if x >= 3 else 0
            b = prev[x]
            c = prev[x - 3] if x >= 3 else 0
            if f == 1:
                cur[x] += a
            elif f == 2:
                cur[x] += b
            elif f == 3:
                cur[x] += (a + b) // 2
            elif f == 4:
                p = a + b - c
                pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                cur[x] += a if (pa <= pb and pa <= pc) else (b if pb <= pc else c)
            cur[x] &= 0xFF
        out[y], prev = cur, cur
    return out.reshape(h, w, 3).astype(np.float32) / 255.0


def psnr_u8(img: np.ndarray, golden: np.ndarray) -> float:
    """utils.testing.golden_compare's metric: 8-bit quantise, then PSNR."""
    got = (np.clip(img, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8).astype(np.float32) / 255.0
    mse = float(np.mean((got.astype(np.float64) - golden.astype(np.float64)) ** 2))
    return float("inf") if mse <= 0 else 10.0 * np.log10(1.0 / mse)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's kernels need one", file=sys.stderr)
        return 1
    from fyp_bidirectionalpathtracer_tpu_torch import cuda
    from fyp_bidirectionalpathtracer_tpu_torch.accel import frame as frame_mod
    from fyp_bidirectionalpathtracer_tpu_torch.ops import compact, splat_tile
    from fyp_bidirectionalpathtracer_tpu_torch.passes.gbuffer import pixel_jitter_for_frame
    from fyp_bidirectionalpathtracer_tpu_torch.pipeline.renderer import (
        BDPT_FRAME_INIT,
        GBUF_FRAME_INIT,
        Renderer,
    )
    from fyp_bidirectionalpathtracer_tpu_torch.scene.scene import Scene
    from fyp_bidirectionalpathtracer_tpu_torch.shared import (
        BDPTConfig,
        RenderConfig,
        cornell_box,
        icosphere,
        many_light_scene,
    )

    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60).stdout.strip().splitlines()[0]
    log(smi)
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}")
    t0 = time.perf_counter()
    cuda.build()
    cuda.library()
    log(f"kernel build + load: {time.perf_counter() - t0:.1f} s")
    kernels = {}

    # ---- phase 2: K2 at the main path's shape ----------------------------
    n_pix = WIDTH * HEIGHT
    u = DEPTH * n_pix
    sent = ((n_pix + 1023) // 1024) * 1024
    g = torch.Generator().manual_seed(0)
    live = torch.rand(u, generator=g) < LIVE_FRAC
    keys = torch.where(live, torch.randint(0, n_pix, (u,), generator=g),
                       torch.full((u,), n_pix)).to(torch.int32)
    rgb = torch.rand(u, 3, generator=g) * 0.9
    pay = splat_tile.pack_rgb8e(rgb[:, 0], rgb[:, 1], rgb[:, 2])
    keys_d, pay_d = keys.to(dev), pay.to(dev)
    kk, kp, kn = compact.compact_live(keys_d, pay_d, n_pix, sent)
    pk, pp, pn = compact.compact_plain(keys_d, pay_d, n_pix, sent)
    torch.cuda.synchronize()
    n_live = int(pn.item())
    if not (torch.equal(kk, pk) and torch.equal(kp, pp) and torch.equal(kn, pn)):
        raise AssertionError("K2 differs from its plain version")
    k2_ms = time_ms(lambda: compact.compact_live(keys_d, pay_d, n_pix, sent), 20)
    k2_plain = time_ms(lambda: compact.compact_plain(keys_d, pay_d, n_pix, sent), 5)
    log(f"K2 compaction U={u} live={n_live}: bit-equal; kernel {k2_ms:.4f} ms, "
        f"plain {k2_plain:.4f} ms")
    kernels["compact"] = dict(max_abs_err=0.0, ms=k2_ms, plain_ms=k2_plain)

    # ---- phase 3: K3 on the sorted live prefix ---------------------------
    ls, order = torch.sort(kk[:n_live], stable=True)
    p8 = kp[:n_live][order].contiguous()
    out_k = splat_tile.splat_reduce(ls, p8, n_pix)
    out_p = splat_tile.reduce_sorted_plain(ls, p8, n_pix)
    torch.cuda.synchronize()
    if not torch.equal(out_k[:, 3], out_p[:, 3]):
        raise AssertionError("K3 counts differ from its plain version")
    torch.testing.assert_close(out_k[:, :3], out_p[:, :3], rtol=1e-5, atol=1e-6)
    k3_err = float((out_k - out_p).abs().max())
    k3_ms = time_ms(lambda: splat_tile.splat_reduce(ls, p8, n_pix), 20)
    k3_plain = time_ms(lambda: splat_tile.reduce_sorted_plain(ls, p8, n_pix), 5)
    log(f"K3 reduction M={n_live}: counts equal, rgb max |err| {k3_err:.3e} "
        f"(rtol 1e-5, atol 1e-6); kernel {k3_ms:.4f} ms, plain {k3_plain:.4f} ms")
    kernels["splat_tile"] = dict(max_abs_err=k3_err, ms=k3_ms, plain_ms=k3_plain)

    # ---- phase 4: K1 against its plain version ---------------------------
    def scene(name, w, h):
        built = many_light_scene() if name == "many_light" else cornell_box()
        if name == "cornell_icosphere":
            built.meshes.append(icosphere((0.5, 0.5, 0.5), 0.2, 0, subdivisions=3))
        return Scene.from_built(built, aspect=w / h).bake(device=dev)

    cfg_for = lambda w, h: RenderConfig(width=w, height=h,  # noqa: E731
                                        bdpt=BDPTConfig(max_depth=DEPTH))
    jitter = pixel_jitter_for_frame(BDPT_FRAME_INIT)

    def image_stats(a, b):
        """The CPU parity bounds on images: share of pixels off by > 1e-3
        (<= 0.02), mean |d| (< 5e-3), mean radiance difference (< 2e-3)."""
        d = (a - b).abs()
        frac = float((d.amax(-1) > 1e-3).float().mean())
        mad, dmean = float(d.mean()), abs(float(a[..., :3].mean() - b[..., :3].mean()))
        return frac, mad, dmean, frac <= 0.02 and mad < 5e-3 and dmean < 2e-3

    # three scenes at 256x144; one size that is no multiple of the 128-thread
    # block, so the kernel's tail runs; the main path's 1280x720
    k1_err = k1_frac = 0.0
    for name, w, h in (("cornell", 256, 144), ("cornell_icosphere", 256, 144),
                       ("many_light", 256, 144), ("cornell", 250, 143),
                       ("cornell", WIDTH, HEIGHT)):
        baked = scene(name, w, h)
        args = frame_mod.frame_args(baked, w, h, BDPT_FRAME_INIT, jitter, cfg_for(w, h),
                                    gbuf_frame=GBUF_FRAME_INIT, splat_rgb8e=True)
        ko = frame_mod.frame_kernel(args, baked.light_rows, baked.tri_pack)
        po = frame_mod.frame_plain(args, baked.light_rows, baked.tri_pack)
        torch.cuda.synchronize()
        d_gb = (ko.gbuf - po.gbuf).abs().max(0).values
        frac_gb = float((d_gb > 1e-3).float().mean())
        frac_img, mad, dmean, img_ok = image_stats(ko.res.T, po.res.T)
        live_k, live_p = ko.splat_pix < args.n_pix, po.splat_pix < args.n_pix
        either, both = live_k | live_p, live_k & live_p
        pix_eq = float((ko.splat_pix[either] == po.splat_pix[either]).float().mean())
        pay_eq = float((ko.splat_pay[both] == po.splat_pay[both]).float().mean())
        k1_err = max(k1_err, float((ko.res - po.res).abs().max()), float(d_gb.max()))
        k1_frac = max(k1_frac, frac_img, frac_gb)
        log(f"K1 {name} ({baked.n_tris} tris, {int(baked.data.lights.count)} lights) "
            f"{w}x{h}: G-buffer frac>1e-3 {frac_gb:.4f} (<= 0.01), image frac>1e-3 "
            f"{frac_img:.4f} (<= 0.02), mean|d| {mad:.2e} (< 5e-3), mean radiance "
            f"d {dmean:.2e} (< 2e-3), splat pixel ids equal on {pix_eq:.4f} of "
            f"{int(either.sum())} lanes live on either side (>= 0.98), payload equal "
            f"on {pay_eq:.4f} of {int(both.sum())} lanes live on both (>= 0.98)")
        if not (frac_gb <= 0.01 and img_ok and pix_eq >= 0.98 and pay_eq >= 0.98
                and int(both.sum()) > 0):
            raise AssertionError(f"K1 differs from its plain version on {name} {w}x{h}")
    # `args` and `baked` are the 1280x720 Cornell frame's now
    k1_ms = time_ms(lambda: frame_mod.frame_kernel(args, baked.light_rows, baked.tri_pack), 10)
    k1_plain = time_ms(lambda: frame_mod.frame_plain(args, baked.light_rows, baked.tri_pack),
                       1, warmup=1)
    log(f"K1 alone at {WIDTH}x{HEIGHT} Cornell: kernel {k1_ms:.4f} ms, plain {k1_plain:.2f} ms")
    # max_abs_err includes the edge-tie pixels the statistical bounds admit;
    # max_frac_over_1e-3 is the worst share of pixels off by more than 1e-3
    kernels["frame"] = dict(max_abs_err=k1_err, max_frac_over_1e_3=k1_frac,
                            ms=k1_ms, plain_ms=k1_plain)

    # the whole frame after the splats: K1 + K2 + sort + K3 against the
    # plain chain, through `render_frame_megakernel`
    for w, h in ((250, 143), (WIDTH, HEIGHT)):
        cb = scene("cornell", w, h)
        got = [frame_mod.render_frame_megakernel(
            cb, w, h, BDPT_FRAME_INIT, jitter, cfg_for(w, h),
            gbuf_frame=GBUF_FRAME_INIT, plain=plain)[1] for plain in (False, True)]
        frac_img, mad, dmean, img_ok = image_stats(*got)
        log(f"frame with splats {w}x{h}, kernels vs plain chain: frac>1e-3 "
            f"{frac_img:.4f} (<= 0.02), mean|d| {mad:.2e} (< 5e-3), mean radiance "
            f"d {dmean:.2e} (< 2e-3)")
        if not img_ok:
            raise AssertionError(f"the frame with splats differs from the plain chain "
                                 f"at {w}x{h}")

    # ---- phase 5: the main path --------------------------------------------
    cfg = cfg_for(WIDTH, HEIGHT)
    renderer = Renderer(baked, cfg)
    warmup, frames = 3, 10
    cuda.reset_launch_counts()
    for _ in range(warmup):
        renderer.render_frame()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    t_host = time.perf_counter()
    start.record()
    for _ in range(frames):
        out = renderer.render_frame()
    end.record()
    torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t_host) * 1e3 / frames
    launches = dict(cuda.LAUNCHES)
    ms = start.elapsed_time(end) / frames
    mrays = n_pix * RAYS_PER_PIXEL / (ms * 1e-3) / 1e6
    log(f"main path {WIDTH}x{HEIGHT} d={DEPTH}: {ms:.4f} ms/frame, {mrays:.1f} Mrays/s "
        f"({RAYS_PER_PIXEL} rays/pixel; host clock {host_ms:.4f} ms/frame), "
        f"launches {launches}")
    if not bool(torch.isfinite(out).all()):
        raise AssertionError("main path output is not finite")
    if tuple(out.shape) != (HEIGHT, WIDTH, 4) or int(renderer.state.accum.count) != warmup + frames:
        raise AssertionError("main path output has the wrong shape or count")
    for key in ("frame", "compact", "splat_tile"):
        if launches[key] < frames:
            raise AssertionError(f"kernel {key} launched {launches[key]} times in "
                                 f"{warmup + frames} frames")
    twice = []
    for _ in range(2):
        r = Renderer(baked, cfg)
        r.render_frame()
        twice.append({k: v.clone() for k, v in r.channels.items()})
    if not all(torch.equal(twice[0][k], twice[1][k]) for k in twice[0]):
        raise AssertionError("the same frame rendered twice differs")
    log("same frame rendered twice: bit-identical")

    # ---- phase 6: golden ------------------------------------------------------
    small = Renderer(scene("cornell", 64, 64), RenderConfig(width=64, height=64))
    small.render(8)
    value = psnr_u8(small.display().cpu().numpy(), read_png_rgb8(GOLDEN))
    log(f"golden cornell_bdpt_8f_64: PSNR {value:.2f} dB (>= {MIN_PSNR})")
    if not value >= MIN_PSNR:
        raise AssertionError("golden image mismatch")

    meta = {
        "frame": ("fyp_bidirectionalpathtracer_tpu_torch/csrc/frame.cu",
                  "fyp_bidirectionalpathtracer_tpu/accel/pallas_frame.py:550"),
        "compact": ("fyp_bidirectionalpathtracer_tpu_torch/csrc/compact.cu",
                    "fyp_bidirectionalpathtracer_tpu/ops/compact.py:100"),
        "splat_tile": ("fyp_bidirectionalpathtracer_tpu_torch/csrc/splat_tile.cu",
                       "fyp_bidirectionalpathtracer_tpu/ops/splat_tile.py:119"),
    }
    log(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": meta[name][0], "replaces": meta[name][1],
         "launches": launches[name], **kernels[name]}
        for name in ("frame", "compact", "splat_tile")]}))
    log(smi)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
