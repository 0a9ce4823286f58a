"""Trilinear sampling contracts (model: reference tests/test_gpu_raytrace.py).

A trilinear interpolant of a linear field is exact; out-of-bounds points get
NaN (trilinear_packed) or a fill value (trilinear_sample)."""

import numpy as np
import jax.numpy as jnp

from raytracinggrff_jax.grids import UniformGrid
from raytracinggrff_jax.ops.trilinear import (
    pack_fields, trilinear_packed, trilinear_sample)


def _linear_cube(n=33, lo=-1.0, hi=1.0):
    g = np.linspace(lo, hi, n, dtype=np.float32)
    x, y, z = np.meshgrid(g, g, g, indexing="ij")
    ne = (x + y + z).astype(np.float32)
    te = (2.0 * y + 3.0 * z - x).astype(np.float32)
    grid = UniformGrid.from_arrays(g, g, g)
    return grid, ne, te


def test_linear_field_exact():
    grid, ne, te = _linear_cube()
    rng = np.random.default_rng(0)
    pts = rng.uniform(-0.95, 0.95, size=(500, 3)).astype(np.float32)
    table = pack_fields(ne, te)
    v, inb = trilinear_packed(table, grid, pts[:, 0], pts[:, 1], pts[:, 2])
    v = np.asarray(v)
    assert np.all(np.asarray(inb))
    np.testing.assert_allclose(v[:, 0], pts.sum(axis=1), rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(
        v[:, 1], 2 * pts[:, 1] + 3 * pts[:, 2] - pts[:, 0],
        rtol=2e-5, atol=2e-5)


def test_out_of_bounds_nan_and_fill():
    grid, ne, _ = _linear_cube()
    pts = np.array([[2.5, 0.0, 0.0], [0.0, -3.0, 0.0], [0.2, 0.1, 0.0]],
                   dtype=np.float32)
    table = pack_fields(ne)
    v, inb = trilinear_packed(table, grid, pts[:, 0], pts[:, 1], pts[:, 2])
    v = np.asarray(v)[:, 0]
    assert list(np.asarray(inb)) == [False, False, True]
    assert np.isnan(v[0]) and np.isnan(v[1]) and np.isfinite(v[2])

    s, _ = trilinear_sample(jnp.asarray(ne), grid,
                            pts[:, 0], pts[:, 1], pts[:, 2], fill_value=7.0)
    s = np.asarray(s)
    assert s[0] == 7.0 and s[1] == 7.0
    np.testing.assert_allclose(s[2], 0.3, rtol=1e-5, atol=1e-5)


def test_nan_position_gives_nan():
    grid, ne, _ = _linear_cube()
    table = pack_fields(ne)
    px = np.array([np.nan, 0.0], dtype=np.float32)
    py = np.array([0.0, 0.0], dtype=np.float32)
    pz = np.array([0.0, 0.0], dtype=np.float32)
    v, inb = trilinear_packed(table, grid, px, py, pz)
    assert not bool(inb[0])
    assert np.isnan(np.asarray(v)[0, 0])


def test_boundary_clamp():
    """Points exactly on the upper boundary are in-bounds (fx == n-1)."""
    grid, ne, _ = _linear_cube()
    table = pack_fields(ne)
    v, inb = trilinear_packed(
        table, grid,
        np.float32([1.0]), np.float32([1.0]), np.float32([1.0]))
    assert bool(inb[0])
    np.testing.assert_allclose(np.asarray(v)[0, 0], 3.0, rtol=1e-5)
