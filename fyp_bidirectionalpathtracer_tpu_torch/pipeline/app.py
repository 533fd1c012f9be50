"""CLI application driver: the Sample/ArgList/SampleTest analogue.

Port of `fyp_bidirectionalpathtracer_tpu/pipeline/app.py`, with the same
options, defaults and choices.  It replaces the reference's windowed app
loop (Sample::runInternal + msgLoop, Sample.cpp:195-287) with a headless
progressive render loop, and its `-test` automation (SampleTest: -ssframes
screenshots, -shutdown frame, JSON results, SampleTest.cpp:368-494) with
the same flags:

  python -m fyp_bidirectionalpathtracer_tpu_torch.pipeline.app \\
      --scene cornell --width 1280 --height 720 --frames 64 \\
      --ssframes 16,64 --outputdir out

It renders on the card (`main(device="cpu")` runs every kernel's plain
version on the CPU) and writes screenshots, the final image and a JSON
results file like the reference's test harness.  `--scene` also takes an
`.fscene` or `.obj` file (`scene/fscene.load_fscene`, `models/obj.
load_obj`); `--animate` advances the scene's camera and object paths by
`--fixedtimedelta` before each frame (`Renderer.animate`); `--export-scene`
writes the loaded scene as an `.fscene` (`scene/fscene.save_fscene`).
`--shard N` splits each frame by rows over N ranks
(`parallel/sharding.launch`: one process a rank, on the host's cards in
turn, over nccl when each rank has a card of its own and gloo when they
share one; `main(device="cpu")` runs them on the CPU over gloo).  Every
rank loads and bakes the scene and renders its rows; rank 0 gathers the
rows and writes the images, results.json and the checkpoint (in the
unsharded format, so either kind of run resumes the other's), and a
`--resume` hands each rank its rows of the loaded state.
"""
from __future__ import annotations

import argparse
import json
import os
import time


def build_arg_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="H100 BDPT renderer (the PyTorch / CUDA port)")
    p.add_argument("--scene", default="cornell",
                   help="'cornell', 'many-lights', 'textured', 'alpha-panel',"
                        " 'pink-room', or a .fscene / .obj path")
    p.add_argument("--width", type=int, default=1280)
    p.add_argument("--height", type=int, default=720)
    p.add_argument("--frames", type=int, default=32, help="frames to accumulate")
    p.add_argument("--max-depth", type=int, default=3)
    p.add_argument("--material", type=int, default=0, choices=[0, 1],
                   help="0 GGX, 1 Lambertian (gMatIndex)")
    p.add_argument("--clamp-upper", type=float, default=0.9)
    p.add_argument("--tonemap", default="clamp",
                   choices=["clamp", "linear", "reinhard", "reinhard_mod",
                            "heji_hable", "hable_uc2", "aces"])
    p.add_argument("--denoise", action="store_true", help="enable BMFR")
    p.add_argument("--regression", action="store_true",
                   help="enable BMFR QR regression stage")
    p.add_argument("--full-screen-denoise", action="store_true",
                   help="disable the reference's half-screen A/B gate")
    p.add_argument("--thin-lens", action="store_true")
    p.add_argument("--envmap", default="",
                   help="lat-long environment image (.png/.hdr) for the "
                        "G-buffer miss path (ResourceManager env-map analogue)")
    p.add_argument("--env-bilinear", action="store_true",
                   help="bilinear env-map filtering (default: nearest, "
                        "reference parity)")
    p.add_argument("--probe", action="store_true",
                   help="pre-integrate the environment map into a light "
                        "probe (LightProbe.cpp:140-167) and also write a "
                        "probe-lit render of the final G-buffer "
                        "(probe_lit.png)")
    p.add_argument("--animate", action="store_true",
                   help="advance the scene camera path each frame")
    p.add_argument("--fixedtimedelta", type=float, default=1.0 / 60.0,
                   help="animation time step (SampleTest -fixedtimedelta)")
    p.add_argument("--ssframes", default="",
                   help="comma-separated frame ids to screenshot")
    p.add_argument("--shutdown", type=int, default=0,
                   help="stop after this frame (0 = run --frames)")
    p.add_argument("--outputdir", default=".")
    p.add_argument("--output", default="render.png")
    p.add_argument("--checkpoint", default="", help="save/resume state path")
    p.add_argument("--resume", action="store_true")
    p.add_argument("--profile", action="store_true")
    p.add_argument("--faithful-rng", action="store_true",
                   help="reproduce the reference's by-value RNG seeds")
    p.add_argument("--shard", type=int, default=0,
                   help="shard the frame by rows over N devices "
                        "(0 = single device)")
    # SampleTest measurement tasks (SampleTest.h:58-62, SampleTest.cpp:
    # 368-494): the reference RECORDS load time / perf ranges / memory
    # ranges into its results JSON and the CI harness judges them
    # (RunTestsSet.py:255-260); thresholds here add in-binary verdicts.
    p.add_argument("--loadtime", nargs="?", const=-1.0, type=float,
                   default=None, metavar="MAX_S",
                   help="record the time from start-up through the first "
                        "rendered frame: scene load, bake and, on a cold "
                        "kernel cache, the nvcc build of the CUDA kernels "
                        "(LoadTimeCheckTask); optional threshold seconds -> "
                        "pass/fail verdict")
    p.add_argument("--perfframes", default="", metavar="A:B[,A:B...]",
                   help="frame ranges whose frame times are recorded "
                        "(PerformanceCheckTask analogue)")
    p.add_argument("--perfrange", default="", metavar="LO:HI",
                   help="acceptable avg sec/frame over each --perfframes "
                        "range -> pass/fail verdict")
    p.add_argument("--memframes", default="", metavar="A:B[,A:B...]",
                   help="frame ranges whose host RSS is sampled "
                        "(MemoryCheckTask analogue)")
    p.add_argument("--memrange", type=float, default=0.0, metavar="MAX_MB",
                   help="max allowed RSS growth (MB) over each --memframes "
                        "range -> pass/fail verdict")
    p.add_argument("--export-scene", default="",
                   help="write the loaded scene to this .fscene path "
                        "(SceneExporter analogue)")
    return p


def load_scene(name: str):
    """A procedural scene by name, or an .fscene or .obj file, as a host
    `Scene` to bake."""
    from ..models.procedural import (
        alpha_panel_scene,
        cornell_box,
        many_light_scene,
        textured_room,
    )
    from ..scene.scene import Scene

    if name == "cornell":
        return Scene.from_built(cornell_box())
    if name == "many-lights":
        return Scene.from_built(many_light_scene())
    if name == "textured":
        return Scene.from_built(textured_room())
    if name == "alpha-panel":
        return Scene.from_built(alpha_panel_scene())
    if name in ("pink-room", "pink_room"):
        from ..models.pink_room import pink_room

        return Scene.from_built(pink_room())
    if name.endswith(".fscene"):
        from ..scene.fscene import load_fscene

        return load_fscene(name)
    if name.endswith(".obj"):
        from ..models.obj import load_obj

        meshes, mats = load_obj(name)
        sc = Scene(meshes=meshes, materials=mats)
        sc.apply_default_fixups()
        return sc
    raise ValueError(f"unknown scene {name!r}")


def _parse_ranges(spec: str) -> list:
    """'A:B,C:D' -> [(A, B), (C, D)] (frame ids, inclusive)."""
    out = []
    for part in spec.split(","):
        if not part.strip():
            continue
        a, b = part.split(":")
        out.append((int(a), int(b)))
    return out


def _rss_mb() -> float:
    """Host resident-set size in MB (the MemoryCheckTask's
    getUsedMemory analogue, SampleTest.cpp:501-509)."""
    try:
        with open("/proc/self/status") as fh:
            for line in fh:
                if line.startswith("VmRSS:"):
                    return float(line.split()[1]) / 1024.0
    except OSError:
        pass
    import resource

    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1024.0


def main(argv=None, device="cuda") -> dict:
    """Run the CLI on `argv`; on the card unless `device` names another.
    Returns the results (rank 0's under --shard)."""
    args = build_arg_parser().parse_args(argv)
    t_start = time.perf_counter()

    from .. import cuda

    device = cuda.resolve_device(device)
    if args.shard:
        from ..parallel import sharding

        results = sharding.launch(_rank_main, args.shard, args, t_start, device=device)[0]
    else:
        results = _run(args, device, None, t_start)
    print(json.dumps({"output": results["output"], "sec_per_frame": results["sec_per_frame"]}))
    return results


def _rank_main(rank, mesh, args, t_start):
    """One rank of a --shard run."""
    return _run(args, mesh.device, mesh, t_start)


def _run(args, device, mesh, t_start: float) -> dict:
    """The CLI's work on `device`; with `mesh`, this rank's rows, where
    rank 0 writes every file."""
    from ..pipeline.renderer import Renderer
    from ..utils.config import (
        AccumulateConfig, BDPTConfig, BMFRConfig, GBufferConfig, RenderConfig,
    )
    from ..utils.image import write_png
    from ..utils.profiler import Profiler, _force

    writer = mesh is None or mesh.rank == 0
    cfg = RenderConfig(
        width=args.width,
        height=args.height,
        bdpt=BDPTConfig(
            max_depth=args.max_depth,
            mat_model=args.material,
            clamp_upper=args.clamp_upper,
            faithful_rng=args.faithful_rng,
        ),
        gbuffer=GBufferConfig(use_thin_lens=args.thin_lens,
                              env_bilinear=args.env_bilinear),
        accumulate=AccumulateConfig(),
        bmfr=BMFRConfig(
            enabled=args.denoise,
            regression=args.regression,
            half_screen_debug=not args.full_screen_denoise,
        ),
        tone_map_operator=args.tonemap,
    )

    scene = load_scene(args.scene)
    if args.envmap:
        from ..utils.image import read_image

        scene.env_map = read_image(args.envmap)
        scene.env_map_file = args.envmap
    if args.export_scene:
        from ..scene.fscene import save_fscene

        scene.apply_default_fixups()  # on every rank: the bake sees it
        if writer:
            save_fscene(scene, args.export_scene)
    max_lights = max(16, len(scene.lights))
    baked = scene.bake(max_lights=max_lights, device=device)
    renderer = Renderer(baked, cfg, mesh=mesh)
    prof = Profiler(enabled=args.profile)

    if args.resume and args.checkpoint:
        from ..utils.checkpoint import load_render_state

        load_render_state(args.checkpoint, renderer)

    os.makedirs(args.outputdir, exist_ok=True)
    ss_frames = {int(s) for s in args.ssframes.split(",") if s.strip()}
    n_frames = args.shutdown or args.frames
    results = {"frames": n_frames, "screenshots": [], "frame_times": []}

    mem_ranges = _parse_ranges(args.memframes)
    perf_ranges = _parse_ranges(args.perfframes)
    mem_samples: dict = {k: [] for k in range(len(mem_ranges))}

    start = renderer.state.frame_index
    for f in range(start, n_frames):
        if args.animate:
            renderer.animate(args.fixedtimedelta)
        t0 = time.perf_counter()
        if args.profile:
            out = renderer.render_frame_profiled(prof)
        else:
            out = renderer.render_frame()
        # the frame's device work is done before its time is taken
        _force(out)
        results["frame_times"].append(time.perf_counter() - t0)
        if f == start and args.loadtime is not None:
            # LoadTimeCheckTask: time from startup through the first
            # rendered frame (scene load + bake + the kernels' build)
            results["load_time"] = time.perf_counter() - t_start
        for k, (a, b) in enumerate(mem_ranges):
            if a <= f <= b:
                mem_samples[k].append(_rss_mb())
        if (f + 1) in ss_frames:
            path = os.path.join(args.outputdir, f"frame_{f + 1:05d}.png")
            img = renderer.display()  # on a mesh, every rank hands in its rows
            if writer:
                write_png(path, img)
            results["screenshots"].append(path)

    final = os.path.join(args.outputdir, args.output)
    img = renderer.display()
    if writer:
        write_png(final, img)
    results["output"] = final

    if args.probe:
        # LightProbe consumer: pre-integrate the loaded env map once
        # (Graphics/LightProbe.cpp:140-167) and shade the final frame's
        # G-buffer with analytic direct + probe IBL (probe_lit_pass).
        # Sizes are demo-scale; the API defaults mirror LightProbe.h:48-51.
        from ..ops.lightprobe import LightProbe
        from ..ops.tonemap import OPERATOR_NAMES, tone_map
        from ..passes.extras import probe_lit_pass

        probe = LightProbe(baked.env_map, diff_samples=1024, spec_samples=256, diff_size=64,
                           spec_size=128, spec_mips=6)
        img = probe_lit_pass(renderer.baked, renderer.baked.intersector(),
                             renderer.channels, probe)
        if mesh is not None:
            img = mesh.gather_rows(img)
        probe_path = os.path.join(args.outputdir, "probe_lit.png")
        if writer:
            write_png(probe_path, tone_map(img[..., :3], OPERATOR_NAMES[args.tonemap]))
        results["probe_lit"] = probe_path
    steady = results["frame_times"][1:] or results["frame_times"]
    results["sec_per_frame"] = sum(steady) / max(len(steady), 1)

    # ---- measurement-task results + verdicts (SampleTest parity) ----
    verdicts: dict = {}
    if args.loadtime is not None and args.loadtime >= 0:
        verdicts["load_time"] = {
            "value": results.get("load_time"),
            "max": args.loadtime,
            "passed": results.get("load_time", 1e30) <= args.loadtime,
        }
    if perf_ranges:
        recs = []
        times = results["frame_times"]
        for a, b in perf_ranges:
            seg = [times[i - start] for i in range(a, b + 1)
                   if 0 <= i - start < len(times)]
            rec = {"frames": [a, b],
                   "avg": sum(seg) / max(len(seg), 1),
                   "min": min(seg, default=0.0),
                   "max": max(seg, default=0.0)}
            if args.perfrange:
                lo, hi = (float(x) for x in args.perfrange.split(":"))
                rec["passed"] = lo <= rec["avg"] <= hi
            recs.append(rec)
        results["perf_ranges"] = recs
        if args.perfrange:
            verdicts["perf"] = {
                "passed": all(r.get("passed", True) for r in recs)}
    if mem_ranges:
        recs = []
        for k, (a, b) in enumerate(mem_ranges):
            s = mem_samples[k]
            rec = {"frames": [a, b],
                   "start_mb": s[0] if s else 0.0,
                   "end_mb": s[-1] if s else 0.0,
                   "delta_mb": (s[-1] - s[0]) if s else 0.0}
            if args.memrange:
                rec["passed"] = rec["delta_mb"] <= args.memrange
            recs.append(rec)
        results["memory_ranges"] = recs
        if args.memrange:
            verdicts["memory"] = {
                "passed": all(r.get("passed", True) for r in recs)}
    if verdicts:
        verdicts["passed"] = all(v.get("passed", True)
                                 for v in verdicts.values())
        results["tests"] = verdicts

    if args.checkpoint:
        from ..utils.checkpoint import save_render_state

        save_render_state(args.checkpoint, renderer)
    if args.profile:
        results["profile"] = prof.as_dict()
        if writer:
            print(prof.report())

    if writer:
        with open(os.path.join(args.outputdir, "results.json"), "w") as fh:
            json.dump(results, fh, indent=1)
    return results


if __name__ == "__main__":
    main()
