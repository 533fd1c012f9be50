"""The port's output passes (passes/extras.py) and NEE functions
(ops/materials.py) against the JAX package's on the CPU, and
test_extras.py's pass behaviour cases on the port.

The passes run on JAX's 24x24 Cornell G-buffer, with JAX's bake carried
across (`baked_scene_from_arrays`).  Each pass's ray batches are recorded
as the intersector answers them: the port's and JAX's visibility (hit
flags) agree on >= 99% of the lanes, and AO and Lambertian + shadows agree
within atol 1e-5 on every pixel whose rays all agree.  Diffuse GI, whose
bounce hits may land on other triangles at edges, is held by the
wavefront's image bounds.  The NEE functions run with a stub shadow
function on seeded points: seeds bit for bit, values atol 1e-5.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fyp_bidirectionalpathtracer_tpu.models.procedural import cornell_box as jcornell_box
from fyp_bidirectionalpathtracer_tpu.ops import materials as jmat
from fyp_bidirectionalpathtracer_tpu.ops.shading import make_shaded_tracer as jmake_shaded_tracer
from fyp_bidirectionalpathtracer_tpu.passes import extras as jextras
from fyp_bidirectionalpathtracer_tpu.passes import gbuffer as jgbuffer
from fyp_bidirectionalpathtracer_tpu.scene import lights as jlights
from fyp_bidirectionalpathtracer_tpu.scene.scene import Scene as JScene
from fyp_bidirectionalpathtracer_tpu_torch.accel import intersect as isect
from fyp_bidirectionalpathtracer_tpu_torch.models.procedural import cornell_box
from fyp_bidirectionalpathtracer_tpu_torch.ops import materials as mat
from fyp_bidirectionalpathtracer_tpu_torch.ops.shading import make_shaded_tracer
from fyp_bidirectionalpathtracer_tpu_torch.passes import extras
from fyp_bidirectionalpathtracer_tpu_torch.passes.gbuffer import ray_traced_gbuffer
from fyp_bidirectionalpathtracer_tpu_torch.scene.lights import light_rows, make_light_array
from fyp_bidirectionalpathtracer_tpu_torch.scene.scene import Scene, baked_scene_from_arrays
from test_torch_textured import jax_scene_arrays
from test_torch_wavefront import _assert_image_bounds
from torch_threads import one_intra_op_thread  # noqa: F401

ATOL = 1e-5
SIZE = 24

LIGHTS = [
    {"type": "point", "pos": (0.0, 1.9, 0.0), "intensity": (4.0, 3.5, 3.0)},
    {"type": "dir", "dir": (0.3, -1.0, 0.2), "intensity": (0.5, 0.6, 0.7)},
    {"type": "point", "pos": (0.5, 1.5, -0.5), "dir": (0.0, -1.0, 0.2),
     "intensity": (2.0, 2.0, 2.0), "opening_angle": 0.7, "penumbra_angle": 0.2},
]


# ------------------------------------------------------------ NEE functions
def _points(n=512, seed=0):
    rs = np.random.RandomState(seed)
    unit = lambda x: (x / np.linalg.norm(x, axis=-1, keepdims=True)).astype(np.float32)  # noqa: E731
    normal, view = unit(rs.normal(size=(n, 3))), unit(rs.normal(size=(n, 3)))
    view *= np.sign((normal * view).sum(-1, keepdims=True))  # N.V > 0, as at a G-buffer hit
    return {
        "seed": rs.randint(0, 2**32, n, dtype=np.uint64).astype(np.uint32),
        "pos": rs.uniform(-1, 1.8, (n, 3)).astype(np.float32),
        "n": normal, "v": view,
        "dif": rs.uniform(0, 1, (n, 3)).astype(np.float32),
        "spec": rs.uniform(0, 1, (n, 3)).astype(np.float32),
        "rough": rs.uniform(0.05, 1, n).astype(np.float32),
    }


def _stub_shadow(record, to_np):
    """Visible on two lanes of three; records the queries it answers."""
    def shadow_fn(o, d, tmin, tmax):
        record.append((to_np(d), to_np(tmax), float(tmin)))
        vis = np.arange(d.shape[0]) % 3 != 0
        return jnp.asarray(vis) if isinstance(d, jnp.ndarray) else torch.from_numpy(vis)
    return shadow_fn


@pytest.mark.parametrize("fn", ["lambertian_direct", "ggx_direct", "eval_direct_ggx",
                                "eval_direct_lambertian"])
def test_nee_function_matches_jax(fn):
    p = _points()
    jl = jlights.make_light_array(LIGHTS, capacity=16)
    pl = make_light_array(LIGHTS, capacity=16)
    rows, count = light_rows(pl), pl.count
    J = {k: jnp.asarray(v) for k, v in p.items()}
    T = {k: torch.from_numpy(v.astype(np.int64) if k == "seed" else v) for k, v in p.items()}
    jrec, trec = [], []
    jshadow, tshadow = _stub_shadow(jrec, np.asarray), _stub_shadow(trec, lambda x: x.numpy())
    if fn == "lambertian_direct":
        want = jmat.lambertian_direct(J["seed"], jshadow, jl, 1e-3, J["pos"], J["n"], J["dif"])
        got = mat.lambertian_direct(T["seed"], tshadow, rows, count, 1e-3, T["pos"], T["n"],
                                    T["dif"])
    else:
        args = ("v", "dif", "spec", "rough")
        jargs, targs = [J[k] for k in args], [T[k] for k in args]
        if fn == "ggx_direct":
            want = jmat.ggx_direct(J["seed"], jshadow, jl, 1e-3, J["pos"], J["n"], *jargs)
            got = mat.ggx_direct(T["seed"], tshadow, rows, count, 1e-3, T["pos"], T["n"], *targs)
        else:
            model = mat.GGX if fn.endswith("ggx") else mat.LAMBERTIAN
            want = jmat.eval_direct(J["seed"], jshadow, jl, 1e-3, J["pos"], J["n"], *jargs,
                                    model)
            got = mat.eval_direct(T["seed"], tshadow, rows, count, 1e-3, T["pos"], T["n"],
                                  *targs, model)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]).astype(np.int64))
    assert got[1].shape == (512, 3) and bool(torch.isfinite(got[1]).all())
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), rtol=0, atol=ATOL)
    (jd, jt, jmin), (td, tt, tmin) = jrec[0], trec[0]
    assert jmin == tmin
    np.testing.assert_allclose(td, jd, rtol=0, atol=ATOL)
    np.testing.assert_allclose(tt, jt, rtol=1e-6, atol=ATOL)


def test_eval_lambertian_brdf_is_the_albedo():
    dif = torch.rand(5, 3)
    assert mat.eval_lambertian_brdf(dif) is dif
    l = torch.nn.functional.normalize(torch.randn(5, 3), dim=-1)
    got = mat.eval_brdf(l, l, l, l, dif, dif, dif[:, 0], dif[:, 0] > 2, mat.LAMBERTIAN)
    assert got is dif


# ----------------------------------------------------- passes against JAX
@pytest.fixture(scope="module")
def cornell():
    """JAX's Cornell bake and 24x24 G-buffer; the port's bake of the same
    arrays and the same channels as tensors."""
    jb = JScene.from_built(jcornell_box(), aspect=1.0).bake()
    frame = jnp.uint32(0xDEADBEEF)
    jitter = jgbuffer.pixel_jitter_for_frame(frame, "msaa8")
    jch = jgbuffer.ray_traced_gbuffer(jb, jmake_shaded_tracer(jb), SIZE, SIZE, frame, jitter)
    jch = {k: np.asarray(v) for k, v in jch.items()}
    pb = baked_scene_from_arrays(jax_scene_arrays(jb), device="cpu")
    ch = {k: torch.from_numpy(v.copy()) for k, v in jch.items()}
    return jb, pb, jch, ch


def _recording(intersect, out, to_np):
    def wrapped(*args, **kw):
        hit = intersect(*args, **kw)
        out.append(to_np(hit.hit).reshape(-1))
        return hit
    return wrapped


def _run_both(cornell, name, **kw):
    """(want, got, where every batch's hit flags agree [H, W])."""
    jb, pb, jch, ch = cornell
    jhits, phits = [], []
    want = np.asarray(getattr(jextras, name)(
        jb, _recording(jb.intersector(), jhits, np.asarray),
        {k: jnp.asarray(v) for k, v in jch.items()}, jnp.uint32(7), **kw))
    got = getattr(extras, name)(pb, _recording(pb.intersector(), phits, lambda x: x.numpy()),
                                ch, 7, **kw).numpy()
    assert got.shape == (SIZE, SIZE, 4) and np.isfinite(got).all()
    if name == "lambertian_shadows_pass":
        # JAX traces every slot of the light table, the port up to its count
        assert len(jhits) == int(jb.data.lights.pos_w.shape[0])
        assert len(phits) == pb.data.lights.count
        jhits = jhits[:len(phits)]
    assert len(jhits) == len(phits) > 0
    jh, ph = np.stack(jhits), np.stack(phits)
    used = np.ones_like(jh)
    if name == "diffuse_gi_pass":
        # the second shadow batch leaves from the bounce hits; lanes whose
        # bounce missed are traced from garbage and their answer dropped
        used[2] = jh[1] & ph[1]
    agree = (jh == ph) | ~used
    assert agree[used].mean() >= 0.99, (~agree).sum()
    return want, got, agree.all(0).reshape(SIZE, SIZE)


@pytest.mark.parametrize("name,kw", [("ambient_occlusion_pass", {"num_rays": 4}),
                                     ("lambertian_shadows_pass", {})],
                         ids=["ao", "lambertian_shadows"])
def test_pass_matches_jax(cornell, name, kw):
    want, got, agree = _run_both(cornell, name, **kw)
    assert agree.mean() >= 0.95
    np.testing.assert_allclose(got[agree], want[agree], rtol=0, atol=ATOL)


def test_diffuse_gi_pass_matches_jax(cornell):
    want, got, _ = _run_both(cornell, "diffuse_gi_pass")
    _assert_image_bounds(want, got)


def test_ao_radius_tensor_and_float_trace_alike(cornell):
    """The AO rays' scalar t_max: `accel/intersect.rays` writes a 0-d
    tensor and a Python float into the same rows."""
    _, pb, _, ch = cornell
    o = ch["WorldPosition"][..., :3]
    d = torch.nn.functional.normalize(ch["WorldNormal"][..., :3] + 0.3, dim=-1)
    radius = torch.tensor(1.7321, dtype=torch.float32)
    a, shape = isect.rays(o, d, 1e-4, radius)
    b, _ = isect.rays(o, d, 1e-4, float(radius))
    assert shape == (SIZE, SIZE)
    np.testing.assert_array_equal(a.numpy(), b.numpy())
    for r in (radius, float(radius)):
        out = extras.ambient_occlusion_pass(pb, pb.intersector(), ch, 3, num_rays=2, ao_radius=r)
        np.testing.assert_array_equal(
            out.numpy(), extras.ambient_occlusion_pass(pb, pb.intersector(), ch, 3, num_rays=2,
                                                       ao_radius=1.7321).numpy())


# ------------------------------------------------- test_extras.py's cases
BEHAVIOUR_SIZE = 48


@pytest.fixture(scope="module")
def setup():
    baked = Scene.from_built(cornell_box(), aspect=1.0).bake(device="cpu")
    ch = ray_traced_gbuffer(baked, make_shaded_tracer(baked), BEHAVIOUR_SIZE, BEHAVIOUR_SIZE,
                            0, torch.tensor([0.5, 0.5]))
    return baked, baked.intersector(), ch


def test_ao_pass(setup):
    baked, intersect, ch = setup
    ao = extras.ambient_occlusion_pass(baked, intersect, ch, 0, num_rays=8).numpy()
    assert np.isfinite(ao).all()
    assert np.all((ao >= 0) & (ao <= 1))
    valid = ch["WorldPosition"].numpy()[..., 3] != 0
    # corners are more occluded than open areas: the interior must spread
    assert ao[valid][:, 0].std() > 0.05


def test_lambertian_shadows_pass(setup):
    baked, intersect, ch = setup
    img = extras.lambertian_shadows_pass(baked, intersect, ch, 0).numpy()
    assert np.isfinite(img).all()
    valid = ch["WorldPosition"].numpy()[..., 3] != 0
    assert img[valid][:, :3].mean() > 0.05  # lit
    assert (img[valid][:, :3] == 0).any()   # shadowed regions exist


def test_diffuse_gi_pass(setup):
    baked, intersect, ch = setup
    img = extras.diffuse_gi_pass(baked, intersect, ch, 0).numpy()
    direct = extras.lambertian_shadows_pass(baked, intersect, ch, 0).numpy()
    assert np.isfinite(img).all()
    valid = ch["WorldPosition"].numpy()[..., 3] != 0
    # GI adds energy over direct-only on average (a single light here, so
    # the Lambertian pass's per-light sum equals NEE's expectation)
    assert img[valid][:, :3].mean() > direct[valid][:, :3].mean() * 0.9


def test_tonemap_and_copy_pass(setup):
    _, _, ch = setup
    ch = dict(ch)
    ch["PipelineOutput"] = torch.full((BEHAVIOUR_SIZE, BEHAVIOUR_SIZE, 4), 2.0)
    out = extras.tone_mapping_pass(ch, operator="aces").numpy()
    assert out[..., :3].max() <= 1.0
    want = np.asarray(jextras.tone_mapping_pass({"PipelineOutput": jnp.full(
        (BEHAVIOUR_SIZE, BEHAVIOUR_SIZE, 4), 2.0)}, operator="aces"))
    np.testing.assert_allclose(out, want, rtol=0, atol=1e-6)
    cp = extras.copy_to_output_pass(ch, "PipelineOutput")
    np.testing.assert_array_equal(cp.numpy(), ch["PipelineOutput"].numpy())
