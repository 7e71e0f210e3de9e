"""The port's bicubic sampling and pixel alignment against the JAX package's
(``ops/geometry.py:grid_sample_bicubic`` / ``pixel_alignment``) on seeded
numpy inputs: interior points, points on the image's edges and corners,
points outside it and non-finite ones.  Tolerance 1e-5 abs: both sum 16
float32 products of the same Keys weights, in another order."""

import numpy as np
import pytest
import jax.numpy as jnp
import torch
import torch.nn.functional as F

from alignsdf_tpu.ops.geometry import grid_sample_bicubic as jax_grid_sample_bicubic
from alignsdf_tpu.ops.geometry import pixel_alignment as jax_pixel_alignment
from alignsdf_torch.ops.geometry import grid_sample_bicubic, pixel_alignment

ATOL = 1e-5


def _uv(rng, batch, n_random):
    """(batch, N, 2): random interior points, the four edges and corners
    exactly, points just and far outside, and non-finite coordinates."""
    edge = [(-1.0, -1.0), (1.0, 1.0), (-1.0, 1.0), (1.0, -1.0), (-1.0, 0.3), (1.0, -0.7),
            (0.2, -1.0), (-0.4, 1.0), (0.0, 0.0)]
    outside = [(-1.01, 0.1), (1.02, 0.5), (0.3, -1.2), (0.1, 1.4), (-3.0, -3.0), (2.5, 0.0),
               (1e6, 0.2), (-1e7, -1e7)]
    bad = [(np.nan, 0.1), (0.2, np.nan), (np.inf, 0.0), (0.0, -np.inf), (np.nan, np.nan)]
    fixed = np.asarray(edge + outside + bad, np.float32)
    uv = rng.uniform(-1.0, 1.0, (batch, n_random, 2)).astype(np.float32)
    return np.concatenate([uv, np.broadcast_to(fixed, (batch,) + fixed.shape)], axis=1)


@pytest.mark.parametrize("shape,n_random", [((2, 5, 8, 7), 40), ((1, 256, 64, 64), 490)])
def test_grid_sample_bicubic_matches_jax(shape, n_random):
    """A small odd-sized map and the reference's 256 x 64 x 64 HeadNet map."""
    rng = np.random.RandomState(0)
    feat = rng.randn(*shape).astype(np.float32)
    uv = _uv(rng, shape[0], n_random)
    want = np.asarray(jax_grid_sample_bicubic(jnp.asarray(feat), jnp.asarray(uv)))
    got = grid_sample_bicubic(torch.from_numpy(feat), torch.from_numpy(uv)).numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
    # samples far off the map, and non-finite ones, are exactly zero
    assert not got[:, -9:].any()


def test_grid_sample_bicubic_matches_torch_grid_sample():
    """The reference's own call, F.grid_sample(mode='bicubic',
    align_corners=True, padding_mode='zeros'), on finite points."""
    rng = np.random.RandomState(1)
    feat = torch.from_numpy(rng.randn(2, 6, 9, 8).astype(np.float32))
    uv = torch.from_numpy(_uv(rng, 2, 50)[:, :-5].copy())
    want = F.grid_sample(feat, uv[:, None], mode="bicubic", align_corners=True,
                         padding_mode="zeros")[:, :, 0].transpose(1, 2)
    np.testing.assert_allclose(grid_sample_bicubic(feat, uv).numpy(), want.numpy(),
                               atol=ATOL, rtol=0)


@pytest.mark.parametrize("shape", [(2, 6, 8, 8), (1, 256, 64, 64)])
def test_pixel_alignment_matches_jax(shape):
    """Points that project inside, outside, exactly onto the camera plane
    (zh = 0: non-finite image coordinates) and behind it; the outside ones
    take the map's mean, and nothing is NaN."""
    rng = np.random.RandomState(2)
    batch = shape[0]
    n = 480 // batch
    feat = rng.randn(*shape).astype(np.float32)
    xyz = rng.uniform(-1.0, 1.0, (batch, n, 3)).astype(np.float32)
    root = np.asarray([[[0.01, -0.02, 2.0]]] * batch, np.float32)
    # with scale factor 2, xyz_cam = xyz + root: z = -2 lies on the camera
    # plane exactly, z < -2 behind it
    xyz[:, 0, 2] = -2.0
    xyz[:, 1, :] = [0.0, 0.0, -2.0]
    xyz[:, 2, 2] = -2.5
    cam = np.tile(np.asarray([[[480.0, 0, 128, 0], [0, 480.0, 128, 0], [0, 0, 1, 0]]],
                             np.float32), (batch, 1, 1))
    args = (feat, xyz.reshape(-1, 3), cam, root)
    want = np.asarray(jax_pixel_alignment(*map(jnp.asarray, args), 256, 2.0))
    got = pixel_alignment(*map(torch.from_numpy, args), 256, 2.0).numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
    mean = feat.mean(axis=(2, 3))
    np.testing.assert_allclose(got.reshape(batch, n, -1)[:, 1], mean, atol=ATOL, rtol=0)
    inside = ~np.isclose(got.reshape(batch, n, -1), mean[:, None], atol=ATOL).all(axis=2)
    assert 0.1 < inside.mean() < 0.9, "both the sample and the mean fallback must be exercised"
