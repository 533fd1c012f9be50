"""Render configuration (the analogue of the reference's three config tiers:
compile-time defines, SampleConfig/ArgList CLI, and per-pass GUI variables —
SURVEY.md §5).  All fields here are *static* under jit: changing one
recompiles, which replaces the reference's shader-define toggles
(RayLaunch::addDefine) and refresh-flag machinery.

The port's own copy of `fyp_bidirectionalpathtracer_tpu/utils/config.py`:
the same dataclasses, fields and defaults (held equal by
`tests/test_torch_scene.py`), so that the port imports nothing of the JAX
package.  The frame options (`splat_mode`, `splat_segments`,
`sort_bounces`, `sort_shadows`, `reverse_shadows`, `merge_shadow_batches`
and the `debug_stub_*` stubs) act as in the JAX package: `passes/bdpt.py`
and `ops/splat.py` say how.  The comments' times and rates are the JAX
package's, measured on a TPU."""
from __future__ import annotations

from dataclasses import dataclass, field, replace


@dataclass(frozen=True)
class BDPTConfig:
    """BDPTPass GUI/CB parameters (BDPTPass.h:32-40, BDPTPass.cpp:79-94)."""

    max_depth: int = 3            # mUserSpecifiedRayDepth (GUI 0..8)
    max_possible_depth: int = 8   # mMaxPossibleRayDepth (path arrays 9)
    mat_model: int = 0            # gMatIndex: 0 GGX, 1 Lambertian
    clamp_upper: float = 0.9      # mClampUpper
    refractive_index: float = 1.0  # gRefractiveIndex (dielectric hook)
    emit_mult: float = 1.0        # gEmitMult
    min_t: float = 1.0e-3         # ResourceManager shared mMinT
    # --- fidelity switches (ours) ---
    # faithful_rng: reproduce the reference's by-value seed in sampleBRDF
    # (MaterialUtils.hlsli:130): subpath bounces re-draw the same randoms.
    faithful_rng: bool = False
    # reference_quirks: keep (a) the stale path vertex recorded at a miss
    # bounce (globalIlluminationRay.hlsli:14-19 leaves payload geometry from
    # the previous hit), (b) getUnweightedContribution's aL index bug
    # (BDPTUtils.hlsli:198 uses cameraIndex for the light path).
    reference_quirks: bool = True
    # connection weighting: 'uniform' = shipped 1/pathLength
    # (BDPTMain.rt.hlsl:164,197,228); 'power'/'balance' = corrected MIS from
    # the dead getWeightPower/getWeightLinear code (BDPTUtils.hlsli:226-278).
    connection_weight: str = "uniform"
    # estimator family toggles (ours; the reference always runs all three)
    enable_path_tracing: bool = True    # estimator 1 (NEE path tracing)
    enable_light_tracing: bool = True   # estimator 2 (camera splats)
    enable_connections: bool = True     # estimator 3 (s,t connections)
    # splat accumulation strategy (see ops.splat.MODES): 'auto' =
    # tiled_rgb8e on TPU (sort + MXU one-hot tile sums with an 8-bit
    # shared-exponent payload pack; full-pipeline 21.9 vs 27.0 ms/frame for
    # plain 'tiled', benchmarks/cornell_splat_micro.py) / direct elsewhere;
    # 'direct' 4 flat scatter-adds, 'sorted' sort+segment-sum+per-channel
    # sorted scatter, 'packed' sort+segment-sum+one i32 scatter-max+one wide
    # gather, 'complex' two complex64 scatter-adds (measured 10x slower on
    # TPU; kept for documentation), 'tiled*' the Pallas tile kernel family
    # (ops/splat_tile.py)
    splat_mode: str = "auto"
    # Per-depth segment sorts inside the tiled splat (ops/splat_tile.py
    # `segments`): S batched sorts of U/S updates instead of one flat
    # U-update sort.  Default OFF: in-frame measured-NEGATIVE on v5e —
    # a [S, U/S] f32 sort operand is sublane-padded to 8 rows, so at S=3
    # the sort moves ~2.7x the flat sort's bytes (segments_on 34.3 ms vs
    # flat ~22 ms whole Cornell 720p frame, round 4), plus S DMA pipelines
    # + S one-hot dots per tile in the kernel.  Kept as an opt-in because
    # per-depth runs preserve the reference's depth-major accumulation
    # order with a cheaper key (no depth bits needed).
    splat_segments: bool = False
    # whole-frame megakernel (accel.pallas_frame): 'auto' uses it on TPU for
    # scenes in its scope (untextured, constant env, pinhole, uniform
    # weights), 'on' forces it (interpret mode off-TPU; tests), 'off' always
    # uses the per-bounce wavefront.
    megakernel: str = "auto"
    # deferred texturing: let base-color(+emissive)-textured scenes use the
    # whole-frame megakernel — the kernel shades with each material's MEAN
    # texture color and the texture/mean ratio is applied per estimator term
    # after the kernel (every term is monomial in per-vertex diffuse albedo;
    # see accel.pallas_frame).  Estimator deviation vs the reference: lobe
    # -selection probabilities (probabilityToSampleDiffuse,
    # MaterialUtils.hlsli:22-27) use the mean rather than the texel albedo —
    # same expectation, different (usually lower) variance weighting.
    # Default OFF: measured net-negative on v5e at 720p d=3 (342-tri room:
    # deferred 270 ms vs wavefront 162 — benchmarks/replay_inframe_micro.py).
    # The replay's ratio math is ~4 ms (field-major), but its 7 per-vertex
    # texture taps pay the in-frame gather tier (~24 ms per 1M indices from
    # an argument-resident atlas) = ~155 ms/frame, more than the whole
    # wavefront.  Re-default if taps drop below ~8 ms/1M.
    defer_textures: bool = False
    # Secondary-vertex shading with per-material MEAN texture colors instead
    # of per-texel taps (textured scenes, wavefront lean bounce decodes
    # only; primary hits always tap exactly).  The reference taps textures
    # at every path vertex (BDPTUtils.hlsli:2-53); on TPU each bounce
    # decode's combined-atlas tap is a ~22 ms/1M-ray HBM gather
    # — the single largest per-trace glue cost on the textured flagship.
    # Estimator deviation when on: indirect bounces carry mean albedo
    # (diffuse interreflection loses texel detail); direct lighting, the
    # G-buffer and emissive stay exact.  Default ON — measured round 4:
    # textured room 164 -> 113 ms/frame, pink_room 733 -> 681; accumulated
    # -image PSNR exact-vs-mean 40.0 dB (textured, 64 frames) / 54.3 dB
    # (pink_room, 32 frames), far above the 35 dB north-star bar.  Set
    # False for reference-exact per-vertex taps (parity tests do); CPU
    # pipeline paths ignore the flag (their gather decode has no tap to
    # skip).  See PARITY.md.
    bounce_tex_mean: bool = True
    # Direction-major-sort bounce wavefronts before the cluster-tier closest
    # trace (ops.raysort dirq keys): BRDF-sampled extension rays have
    # coherent origins but scattered directions, which defeats the
    # [8,128]-tile AABB culling of accel.pallas_cluster.  No effect on
    # dense/jnp tiers (order-insensitive) or on the image (the permutation
    # is inverted).  Default ON since the permutations ride payload-carrying
    # sorts: pink_room 1278 -> 1130 ms/frame at 720p d=3 (was net-NEGATIVE,
    # 1351 -> 1435, when the unsort was two 11-column permutation gathers —
    # benchmarks/vmem_gather_micro.py, scene_frame_micro.py).
    sort_bounces: bool = True
    # Direction-major-sort the batched est-1/est-2 shadow queries too
    # (est-3's s,t-connection rays are always sorted).  est-1 rays start at
    # scattered bounce vertices toward random light points; est-2 rays
    # converge on the camera.  Exact-visit counts say sorting cuts the
    # cluster shortlist ~5x (consv_gap micro: 125 -> 26.3 visits/cell);
    # flag so the frame-level win/loss is measurable.
    sort_shadows: bool = True
    # Trace est-1/est-2 shadow rays REVERSED — from the light point / camera
    # toward the surface vertex instead of the reference's vertex-outward
    # orientation (BDPTMain.rt.hlsl:118-120, 191-196).  Any-hit visibility
    # over an open segment is orientation-symmetric (no backface culling on
    # shadow rays), and the reversed wavefront shares ONE origin per lane
    # population (the camera; each light), so the direction-major sort turns
    # it into single-origin cones.  MEASURED NET-NEGATIVE on v5e
    # (pink_room 779.9 -> 789.7 ms/frame at 720p d=3): the direction-sorted
    # vertex-outward batches are already as coherent as the cones (origins
    # lie on visible surfaces, directions converge), the any-hit kernel has
    # no best_t for the front-to-back order to exploit, and the reversal
    # pays an lpos reconstruction per lane.  Kept behind this flag as a
    # recorded negative (equivalence-tested:
    # tests/test_features.py::test_reverse_shadows_matches_reference_orientation).
    # Differences vs the reference orientation are pure FP rounding at
    # grazing hits (same open interval (min_t, dist) tested from the other
    # end); est-3 connection rays keep their orientation either way.
    reverse_shadows: bool = False
    # Trace the camera and light subpath extension wavefronts TOGETHER:
    # per bounce depth, the camera-ext and light-ext rays merge into ONE
    # direction-sorted 2x-wavefront (5 divergent closest traces -> 3),
    # amortizing the per-trace sort/launch glue AND tightening the
    # direction-sort cells (same 1024-ray cells over twice the rays =
    # roughly half the direction spread per cell -> shorter exact cluster
    # shortlists; the win the round-4 sub-cell experiment was after,
    # without its sublane-padding tax).  DEVIATION: the reference threads
    # ONE sequential RNG through camera-then-light subpaths per pixel
    # (BDPTMain.rt.hlsl:73-145); merging the traces requires the light
    # subpath to draw from an INDEPENDENT stream (TEA-seeded with a
    # salted frame id), so per-sample noise differs from the reference's
    # while every estimator expectation is unchanged (statistically
    # identical Monte Carlo; tests/test_features.py pins converged-mean
    # agreement).  Default OFF: bit-comparable sequences are the parity
    # baseline (PARITY.md); flip on for production throughput on divergent
    # -heavy scenes (pink_room, measured round 5 in BASELINE.md).
    parallel_subpaths: bool = False
    # Fire ALL estimator visibility queries (est-1 NEE + est-3 connections
    # + est-2 camera splats) as ONE direction-sorted any-hit batch instead
    # of three per-family batches.  Output-identical (visibility rays are
    # independent; same rays, same intervals).  Round 3 measured the merge
    # WORSE pre-premask (811 vs 781 ms pink_room: mixed populations spread
    # per-cell origin bounds); this flag retests it under the premasked
    # round-5 tree — see BASELINE.md for the current number.  Only applies
    # with reverse_shadows=False (the reversed orientations change per
    # -family origins).
    merge_shadow_batches: bool = False
    # --- timing-attribution stubs (NEVER for rendering; both break the
    # image).  debug_stub_shadows short-circuits every estimator visibility
    # query to "visible"; debug_stub_extensions skips the subpath extension
    # traces (XLA then dead-code-eliminates them).  Frame differencing with
    # these isolates any-hit cost / extension-trace cost from estimator
    # math inside ONE jitted frame — standalone micros lie.
    debug_stub_shadows: bool = False
    debug_stub_extensions: bool = False


@dataclass(frozen=True)
class GBufferConfig:
    """LightProbeGBufferPass parameters (LightProbeGBufferPass.h:53-70)."""

    use_thin_lens: bool = False
    f_stop: float = 32.0
    focal_length_gui: float = 1.0  # thin-lens focal length (GUI units)
    jitter_mode: str = "msaa8"     # 'msaa8' | 'random' | 'none'
    # env-map miss filtering: False = nearest texel (reference parity,
    # lightProbeGBuffer.rt.hlsl:64-74), True = bilinear (quality option)
    env_bilinear: bool = False


@dataclass(frozen=True)
class AccumulateConfig:
    """SimpleAccumulationPass (SimpleAccumulationPass.h:70-71)."""

    max_accum_count: int = 100


@dataclass(frozen=True)
class BMFRConfig:
    """DenoisePass toggles + constants (DenoisePass.h:71-75, regressionCP
    defines, preprocess/postprocess alphas)."""

    # master switch; the reference ships with mDoDenoise = false
    # (DenoisePass.h:70) and the GUI enables it
    enabled: bool = False
    preprocess: bool = True
    regression: bool = False
    postprocess: bool = True
    remove_ld_features: bool = True   # IGNORE_LD_fEATURES define
    half_screen_debug: bool = True    # denoise left half only (preprocess:38)
    block_edge: int = 32
    noise_amount: float = 0.01
    position_limit_sq: float = 0.01
    normal_limit_sq: float = 1.0
    blend_alpha: float = 0.2
    second_blend_alpha: float = 0.1
    # regression linear solver:
    # 'qr'     — the reference's Householder QR transliteration
    #            (regressionCP.hlsl:207-466), including its per-column
    #            rank-deficiency skip / add-noise variants;
    # 'normal' — the normal-equations form: the Gram [B,13,13] + a 10-step
    #            Cholesky whose pivot sqrt(G[c,c] - sum L^2) is the QR's
    #            reduced column norm (same >0.01 accept rule, same R, same
    #            back-substitution) up to float32 rounding, which the
    #            squared conditioning magnifies: on rendered blocks it can
    #            differ from the QR (PERF.md, BMFR);
    # 'auto'   — JAX takes 'normal' on the TPU and 'qr' elsewhere; the port
    #            takes 'qr' (passes/bmfr.py).  Both run as plain torch
    #            elementwise products and sums, no matmul.
    regression_solver: str = "auto"
    # history fetch packing for the reprojection taps (pre+postprocess):
    # 'f32'  — exact: [pos3|norm3|noisy4] for preprocess's four taps, then
    #          [filtered3] for postprocess's;
    # 'bf16' — one combined 13-value/tap history table packed as bf16x2
    #          pairs (7 int32 a pixel), preprocess fetching postprocess's
    #          taps too.  On the TPU it halves the gather cost (cost per
    #          index per <=16-col fetch).  Deviation: history pos/norm/
    #          colors quantized to bf16 (<= 2^-8 relative; the accept
    #          thresholds are 0.1 position / 1.0 normal distances, spp <=
    #          256 is bf16-exact, and both blend-alpha floors make spp > 10
    #          behaviorally irrelevant).  The reference keeps f32 history
    #          textures (DenoisePass.cpp:26-37).  The sharded mode packs
    #          before its halo exchange (passes/bmfr.bmfr_pass), as JAX's.
    # 'auto' — JAX takes bf16 on the TPU and f32 elsewhere; the port takes
    #          f32.  bf16 needs preprocess+postprocess both on (the
    #          combined fetch shares one index vector); otherwise f32.
    history_pack: str = "auto"
    # row-sharded frames only (parallel/sharding.py): rows of prev-frame
    # history exchanged across shard boundaries for the reprojection taps
    # (no reference equivalent — the reference is single-GPU).  Taps reprojecting further than this are
    # rejected like off-screen taps; exact vs single-chip while inter-frame
    # motion stays within the margin.
    shard_history_margin: int = 64


@dataclass(frozen=True)
class RenderConfig:
    width: int = 1280
    height: int = 720
    bdpt: BDPTConfig = field(default_factory=BDPTConfig)
    gbuffer: GBufferConfig = field(default_factory=GBufferConfig)
    accumulate: AccumulateConfig = field(default_factory=AccumulateConfig)
    bmfr: BMFRConfig = field(default_factory=BMFRConfig)
    tone_map_operator: str = "clamp"

    def with_(self, **kw) -> "RenderConfig":
        return replace(self, **kw)
