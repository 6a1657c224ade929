"""The port's rotated-box geometry (``r3det_tpu_torch/core/rtransforms.py``)
against the JAX package's, on the CPU in float32, all three angle versions.

Scenes as in tests/test_rtransforms.py: boxes with centres in (100, 900),
sides 4..80 and each version's angle range kept 1e-3 off its ends, their
polygons, jittered quadrilaterals, and xyxy boxes. Tolerance: angles
within 1e-5; coordinates and sides within 1e-5 plus two f32 ulps of the
scene's extent, 1024 (2^-12): XLA's and torch's cos and sin may round a
last bit apart, and a corner near 900 then moves by an ulp of 6.1e-5,
which a centre or an extent taken from the corners carries.
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from r3det_tpu.core import rtransforms as J
from r3det_tpu_torch.core import rtransforms as T

PI = math.pi
VERSIONS = ('v1', 'v2', 'v3')


def random_obb(rng, n, version, wmin=4.0, wmax=80.0):
    """tests/test_rtransforms.py::random_obb on its own generator."""
    cx = rng.uniform(100, 900, n)
    cy = rng.uniform(100, 900, n)
    w = rng.uniform(wmin, wmax, n)
    h = rng.uniform(wmin, wmax, n)
    if version == 'v1':
        a = rng.uniform(-PI / 2 + 1e-3, -1e-3, n)
    else:
        lo, hi = (-PI / 4, 3 * PI / 4) if version == 'v2' else \
            (-PI / 2, PI / 2)
        a = rng.uniform(lo + 1e-3, hi - 1e-3, n)
        w, h = np.maximum(w, h), np.minimum(w, h)
    return np.stack([cx, cy, w, h, a], -1).astype(np.float32)


def scenes(version, seed=0):
    rng = np.random.RandomState(seed)
    obb = random_obb(rng, 128, version)
    polys = np.asarray(J.obb2poly(jnp.asarray(obb), version))
    quads = (polys + rng.uniform(-1.5, 1.5, polys.shape)).astype(np.float32)
    x0 = rng.uniform(0, 800, (64, 2))
    xyxy = np.concatenate([x0, x0 + rng.uniform(1, 120, (64, 2))],
                          -1).astype(np.float32)
    return obb, polys, quads, xyxy


COORD_TOL = 1e-5 + 2.0 ** -12      # two ulps of 1024
ANGLE_TOL = 1e-5


def close(got, want):
    """Boxes (..., 5) have an angle column; polygons (..., 8) and xyxy
    boxes (..., 4) are all coordinates."""
    want = np.asarray(want)
    assert got.shape == want.shape and got.dtype == torch.float32
    tol = np.full(want.shape[-1], COORD_TOL)
    if want.shape[-1] == 5:
        tol[4] = ANGLE_TOL
    assert np.all(np.abs(got.numpy() - want) <= tol), \
        np.abs(got.numpy() - want).max(axis=tuple(range(want.ndim - 1)))


def both(name, x, version):
    return (getattr(T, name)(torch.from_numpy(np.array(x)), version),
            getattr(J, name)(jnp.asarray(x), version))


@pytest.mark.parametrize('version', VERSIONS)
@pytest.mark.parametrize('fn', ['obb2poly', 'obb2hbb', 'obb2xyxy'])
def test_obb_transforms_match_jax(fn, version):
    obb = scenes(version)[0]
    close(*both(fn, obb, version))
    # batched leading dims
    got, want = both(fn, obb.reshape(4, 32, 5), version)
    close(got, want)


@pytest.mark.parametrize('version', VERSIONS)
def test_poly2obb_matches_jax(version):
    _, polys, quads, _ = scenes(version)
    for p in (polys, quads):
        close(*both('poly2obb', p, version))


@pytest.mark.parametrize('version', VERSIONS)
def test_hbb2obb_matches_jax(version):
    close(*both('hbb2obb', scenes(version)[3], version))


@pytest.mark.parametrize('version', VERSIONS)
def test_norm_angle_matches_jax(version):
    a = np.random.RandomState(1).uniform(-3 * PI, 3 * PI, 256).astype(
        np.float32)
    got = T.norm_angle(torch.from_numpy(a), version)
    want = np.asarray(J.norm_angle(jnp.asarray(a), version))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ANGLE_TOL)


def test_obb2hbb_v1_keeps_the_slot_quirk():
    """v1 writes the height extent into the w slot, theta -pi/2."""
    box = torch.tensor([[50.0, 40.0, 30.0, 10.0, -0.3]])
    c, s = math.cos(-0.3), math.sin(-0.3)
    got = T.obb2hbb(box, 'v1')[0]
    assert got[2].item() == pytest.approx(-s * 30 + c * 10, abs=1e-5)
    assert got[3].item() == pytest.approx(c * 30 - s * 10, abs=1e-5)
    assert got[4].item() == pytest.approx(-PI / 2)


def test_unknown_version_raises():
    with pytest.raises(ValueError):
        T.obb2poly(torch.zeros(1, 5), 'v4')
    with pytest.raises(ValueError):
        T.norm_angle(torch.zeros(1), 'v4')
