"""The port's core/ (RNG, jitter) against the JAX package on the CPU.

The TEA/LCG RNG is integer math: seeds and draws must be bit-equal."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from fyp_bidirectionalpathtracer_tpu.core import rng as jrng
from fyp_bidirectionalpathtracer_tpu.core import samplers as jsamplers
from fyp_bidirectionalpathtracer_tpu.passes import gbuffer as jgbuffer
from fyp_bidirectionalpathtracer_tpu_torch.core import rng, samplers
from fyp_bidirectionalpathtracer_tpu_torch.passes.gbuffer import pixel_jitter_for_frame

SIZE = 64


@pytest.mark.parametrize("frame", [0, 0x1337, 0xDEADBEEF, 0xFFFFFFFF])
@pytest.mark.parametrize("row0,sub_height", [(0, None), (17, 23)])
def test_pixel_seeds_and_draws_bit_equal(frame, row0, sub_height):
    js = jrng.pixel_seeds(SIZE, SIZE, jnp.uint32(frame), row0=row0,
                          sub_height=sub_height)
    ts = rng.pixel_seeds(SIZE, SIZE, frame, row0=row0, sub_height=sub_height)
    np.testing.assert_array_equal(np.asarray(js).astype(np.int64), ts.numpy())
    for _ in range(16):
        js, ju = jrng.next_rand(js)
        ts, tu = rng.next_rand(ts)
        np.testing.assert_array_equal(np.asarray(js).astype(np.int64), ts.numpy())
        np.testing.assert_array_equal(np.asarray(ju), tu.numpy())


def test_tea_init_bit_equal_on_random_words():
    rs = np.random.RandomState(0)
    a = rs.randint(0, 2 ** 32, 4096, dtype=np.uint64).astype(np.uint32)
    b = rs.randint(0, 2 ** 32, 4096, dtype=np.uint64).astype(np.uint32)
    want = np.asarray(jrng.tea_init(jnp.asarray(a), jnp.asarray(b)))
    got = rng.tea_init(torch.from_numpy(a.astype(np.int64)),
                       torch.from_numpy(b.astype(np.int64)))
    np.testing.assert_array_equal(want.astype(np.int64), got.numpy())


@pytest.mark.parametrize("frame", range(16))
def test_msaa8_jitter_equal(frame):
    np.testing.assert_array_equal(np.asarray(jsamplers.msaa8_jitter(frame)),
                                  samplers.msaa8_jitter(frame).numpy())


@pytest.mark.parametrize("mode", ["msaa8", "none", "random"])
def test_pixel_jitter_for_frame_equal(mode):
    for frame in (0x1337, 0x1337 + 5):
        np.testing.assert_array_equal(
            np.asarray(jgbuffer.pixel_jitter_for_frame(jnp.uint32(frame), mode)),
            pixel_jitter_for_frame(frame, mode).numpy())
