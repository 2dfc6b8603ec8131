"""The port's device-side feature functions (deepsense6g_tii_tpu_torch/data/
features.py) against the JAX package's on the same numpy inputs, on the
CPU: the static-shape BEV histogram bit for bit for every scenario's field
of view (points on the right edges, out of range, masked, and piled past
the clip at 5), the soft beam targets, the flip's labels and the input
flips.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepsense6g_tii_tpu.data import features as JF
from deepsense6g_tii_tpu_torch.config import DEFAULT_FOV, SCENARIO_FOV
from deepsense6g_tii_tpu_torch.data import features as F
from test_torch_modules import two_torch_threads  # noqa: F401 (autouse)

FOVS = [fov for _, fov in SCENARIO_FOV] + [DEFAULT_FOV]


def cloud(rng, fov, n=6000):
    """Points over and around ``fov``: some on its right edges, some out of
    range, 40 in one pixel (past the clip), with a mask of ~10% padding."""
    x_lo, x_hi, y_lo, y_hi = fov
    pts = np.stack([rng.uniform(x_lo - 3, x_hi + 3, n),
                    rng.uniform(y_lo - 3, y_hi + 3, n),
                    rng.normal(size=n)], 1)
    pts[:30, 0] = x_hi
    pts[30:60, 1] = y_hi
    pts[60:70, :2] = (x_hi, y_hi)
    pts[70:110, :2] = (x_lo + 0.01, y_lo + 0.01)
    mask = (rng.uniform(size=n) > 0.1).astype(np.float32)
    mask[:110] = 1.0
    return pts, mask


@pytest.mark.parametrize("fov", FOVS, ids=[n for n, _ in SCENARIO_FOV]
                         + ["default"])
def test_lidar_to_bev_bit_equal_jax(fov):
    pts, mask = cloud(np.random.default_rng(0), fov)
    got = F.lidar_to_bev(torch.from_numpy(pts), torch.from_numpy(mask), fov)
    want = np.asarray(JF.lidar_to_bev(jnp.asarray(pts), jnp.asarray(mask),
                                      jnp.asarray(fov)))
    assert got.shape == (1, 256, 256) and got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)
    assert got.max().item() == 1.0                    # the clip at 5
    assert got[0, 255].sum().item() > 0 and got[0, :, 255].sum().item() > 0


def test_lidar_to_bev_takes_a_tensor_fov():
    fov = FOVS[1]
    pts, mask = cloud(np.random.default_rng(1), fov, n=500)
    a = F.lidar_to_bev(torch.from_numpy(pts), torch.from_numpy(mask), fov)
    b = F.lidar_to_bev(torch.from_numpy(pts), torch.from_numpy(mask),
                       torch.tensor(fov))
    assert torch.equal(a, b)


@pytest.mark.parametrize("shape", [(7,), (3, 5)])
def test_soft_beam_target_equal_jax(shape):
    idx = np.random.default_rng(2).integers(0, 64, shape)
    idx.flat[0], idx.flat[-1] = 0, 63                 # the window's edges
    got = F.soft_beam_target(torch.from_numpy(idx))
    want = np.asarray(JF.soft_beam_target(jnp.asarray(idx)))
    assert got.shape == (*shape, 64) and got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)


def test_soft_beam_target_near_numpy():
    idx = np.arange(64)
    got = F.soft_beam_target(torch.from_numpy(idx)).numpy()
    want = np.stack([F.soft_beam_target_np(int(i)) for i in idx])
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)


def test_flip_beam_target_equal_jax():
    rng = np.random.default_rng(3)
    beam = rng.uniform(size=(4, 64)).astype(np.float32)
    idx = rng.integers(0, 64, 4)
    got_beam, got_idx = F.flip_beam_target(torch.from_numpy(beam),
                                           torch.from_numpy(idx))
    want_beam, want_idx = JF.flip_beam_target(jnp.asarray(beam),
                                              jnp.asarray(idx))
    np.testing.assert_array_equal(got_beam.numpy(), np.asarray(want_beam))
    np.testing.assert_array_equal(got_idx.numpy(), np.asarray(want_idx))


@pytest.mark.parametrize("shape", [(2, 3, 8, 10, 3), (8, 10, 3)])
def test_hflip_image_equal_jax(shape):
    img = np.random.default_rng(4).uniform(0, 255, shape).astype(np.float32)
    got = F.hflip_image(torch.from_numpy(img)).numpy()
    np.testing.assert_array_equal(got, np.asarray(JF.hflip_image(
        jnp.asarray(img))))
    np.testing.assert_array_equal(got, np.flip(img, -2))


@pytest.mark.parametrize("shape", [(1, 16, 12), (2, 5, 16, 12)])
def test_hflip_map_equal_jax(shape):
    m = np.random.default_rng(5).uniform(size=shape).astype(np.float32)
    got = F.hflip_map(torch.from_numpy(m)).numpy()
    np.testing.assert_array_equal(got, np.asarray(JF.hflip_map(
        jnp.asarray(m))))


@pytest.mark.parametrize("dtype", [np.float64, np.complex128])
def test_radar_maps_take_64_bit_input_as_jax(dtype):
    """64-bit cubes compute in float32 / complex64, as JAX does with 64-bit
    types off."""
    rng = np.random.default_rng(6)
    c = rng.normal(size=(4, 32, 20))
    if dtype == np.complex128:
        c = c + 1j * rng.normal(size=c.shape)
    ra, rv = F.radar_maps(torch.from_numpy(c.astype(dtype)))
    jra, jrv = JF.radar_maps(jnp.asarray(c.astype(dtype)))
    assert ra.dtype == rv.dtype == torch.float32
    np.testing.assert_allclose(ra.numpy(), np.asarray(jra), rtol=0, atol=2e-5)
    np.testing.assert_allclose(rv.numpy(), np.asarray(jrv), rtol=0, atol=2e-5)
