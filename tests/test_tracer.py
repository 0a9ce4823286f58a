"""Ray integrator physics contracts.

Analytic checks: vacuum propagation at C_R, frozen out-of-bounds rays,
cross-section S == 1 in a homogeneous medium, and reflection off an
overdense barrier (omega_pe > omega)."""

import numpy as np
import jax.numpy as jnp
import pytest

from raytracinggrff_jax.constants import C_R
from raytracinggrff_jax.grids import UniformGrid
from raytracinggrff_jax.tracer import (
    pack_trace_table, trace_rays, trace_rays_from_cube, gradient_cubes)


def _vacuum_case(n=33, extent=2.0):
    grid = UniformGrid.cube(extent, n)
    cube = jnp.zeros(grid.shape, jnp.float32)
    table = pack_trace_table(cube, grid)
    return grid, table


def test_vacuum_straight_line_speed():
    grid, table = _vacuum_case()
    start = np.array([[1.5, 0.0, 0.0], [0.0, 1.0, 0.5]], np.float32)
    kdir = np.array([[-1.0, 0.0, 0.0], [0.0, -1.0, 0.0]], np.float32)
    dt, n_steps, stride = 1e-2, 100, 10
    res = trace_rays(table, grid, 75e6, start, kdir, dt, n_steps, stride)
    rec = np.asarray(res.r_record)
    assert rec.shape == (10, 2, 3)
    # record j is after (j*stride + 1) steps
    for j in range(10):
        t = (j * stride + 1) * dt
        expected = start + kdir * C_R * t
        np.testing.assert_allclose(rec[j], expected, rtol=1e-4, atol=1e-5)


def test_out_of_bounds_ray_frozen():
    grid, table = _vacuum_case()
    start = np.array([[5.0, 5.0, 5.0]], np.float32)  # outside the cube
    kdir = np.array([[0.0, 0.0, -1.0]], np.float32)
    res = trace_rays(table, grid, 75e6, start, kdir, 1e-2, 50, 10)
    rec = np.asarray(res.r_record)
    for j in range(rec.shape[0]):
        np.testing.assert_allclose(rec[j, 0], start[0], atol=1e-6)


def test_cross_section_unity_in_homogeneous_medium():
    grid, table = _vacuum_case()
    start = np.array([[1.5, 0.2, -0.3], [0.5, 0.1, 1.2]], np.float32)
    kdir = np.array([[-1.0, 0.0, 0.0], [0.0, 0.0, -1.0]], np.float32)
    res = trace_rays(table, grid, 75e6, start, kdir, 1e-2, 60, 10,
                     trace_crosssections=True, perturb_ratio=2.0)
    s = np.asarray(res.s_record)
    np.testing.assert_allclose(s, 1.0, rtol=1e-3, atol=1e-3)


def test_reflection_off_overdense_barrier():
    """A ray launched at a plasma slab with omega_pe > omega turns around."""
    n, extent = 65, 2.0
    grid = UniformGrid.cube(extent, n)
    xs, _, _ = grid.axes()
    freq = 75e6
    omega0 = 2 * np.pi * freq
    # omega_pe ramps linearly from 0 at x=0 to 2*omega0 at x=-2 (overdense).
    x = xs[:, None, None]
    cube = np.broadcast_to(
        np.where(x < 0, -x * omega0, 0.0), grid.shape).astype(np.float32)
    table = pack_trace_table(jnp.asarray(cube), grid)
    start = np.array([[1.8, 0.0, 0.0]], np.float32)
    kdir = np.array([[-1.0, 0.0, 0.0]], np.float32)
    res = trace_rays(table, grid, freq, start, kdir, 5e-3, 4000, 20)
    rec = np.asarray(res.r_record)[:, 0, 0]
    # The ray must penetrate x<0, stop before omega_pe = omega0 (x=-1),
    # and come back out.
    assert rec.min() < -0.2
    assert rec.min() > -1.05
    assert rec[-1] > 0.5  # reflected back


def test_gradient_cubes_matches_numpy():
    rng = np.random.default_rng(3)
    cube = rng.normal(size=(9, 10, 11)).astype(np.float32)
    g = np.linspace(-1, 1, 9)
    gy = np.linspace(0, 2, 10)
    gz = np.linspace(-2, 0, 11)
    grid = UniformGrid.from_arrays(g, gy, gz)
    gx_j, gy_j, gz_j = gradient_cubes(jnp.asarray(cube), grid)
    gx_n = np.gradient(cube, grid.dx, axis=0)
    gy_n = np.gradient(cube, grid.dy, axis=1)
    gz_n = np.gradient(cube, grid.dz, axis=2)
    np.testing.assert_allclose(np.asarray(gx_j), gx_n, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(np.asarray(gy_j), gy_n, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(np.asarray(gz_j), gz_n, rtol=1e-4, atol=1e-5)


def test_wrapper_matches_reference_shapes():
    """trace_rays_from_cube mirrors the reference trace_ray output shapes."""
    n = 17
    g = np.linspace(-1, 1, n)
    cube = np.zeros((n, n, n), np.float32)
    r_rec, s_rec = trace_rays_from_cube(
        cube, g, g, g, 50e6,
        np.float32([0.9]), np.float32([0.0]), np.float32([0.0]),
        np.float32([[-1, 0, 0]]), 1e-2, 25, record_stride=10,
        trace_crosssections=True)
    assert np.asarray(r_rec).shape == (3, 1, 3)
    assert np.asarray(s_rec).shape == (3, 1)


def test_energy_conservation_refraction():
    """omega^2 = omega_pe^2 + |k|^2 is conserved along the ray (dispersion
    relation invariant of the ODE, ref physics build_rays.py:158-175)."""
    n, extent = 65, 2.0
    grid = UniformGrid.cube(extent, n)
    xs, ys, zs = grid.axes()
    x, y, z = np.meshgrid(xs, ys, zs, indexing="ij")
    r = np.sqrt(x**2 + y**2 + z**2)
    freq = 80e6
    omega0 = 2 * np.pi * freq
    # smooth spherically symmetric underdense profile
    cube = (0.8 * omega0 * np.exp(-(r - 1.0) / 0.5)).astype(np.float32)
    cube[r < 1.0] = 0.8 * omega0
    table = pack_trace_table(jnp.asarray(cube), grid)
    start = np.array([[1.9, 0.3, 0.0]], np.float32)
    kdir = np.array([[-1.0, 0.0, 0.0]], np.float32)
    res = trace_rays(table, grid, freq, start, kdir, 2e-3, 2000, 100)
    state = np.asarray(res.final_state)[0]
    pos, kvec = state[:3], state[3:]
    from raytracinggrff_jax.ops.trilinear import trilinear_sample
    wpe, _ = trilinear_sample(jnp.asarray(cube), grid,
                              np.float32([pos[0]]), np.float32([pos[1]]),
                              np.float32([pos[2]]), fill_value=0.0)
    omega_end = np.sqrt(float(wpe[0]) ** 2 + np.sum(kvec ** 2))
    # kc0 at start: sqrt(omega0^2 - wpe(start)^2); omega stays omega0
    np.testing.assert_allclose(omega_end / omega0, 1.0, rtol=5e-3)


def test_record_k_wave_vectors():
    """record_k=True returns the instantaneous wave vector at each record
    (the quantity theta_mode='los' consumes): in vacuum k is constant and
    equal to k0 = omega0 * k_dir at every record; in a refracting scene the
    last k record equals final_state's k (the tracer stops at the last
    record step)."""
    n, extent = 33, 2.0
    grid = UniformGrid.cube(extent, n)
    freq = 80e6
    omega0 = 2 * np.pi * freq

    vac = jnp.zeros((n, n, n), jnp.float32)
    table = pack_trace_table(vac, grid)
    start = np.array([[1.5, 0.2, 0.1]], np.float32)
    kdir = np.array([[-1.0, 0.0, 0.0]], np.float32)
    res = trace_rays(table, grid, freq, start, kdir, 1e-3, 40, 10,
                     record_k=True)
    k_rec = np.asarray(res.k_record)
    assert k_rec.shape == (4, 1, 3)
    np.testing.assert_allclose(
        k_rec, np.broadcast_to(omega0 * kdir, k_rec.shape), rtol=1e-6)

    xs, ys, zs = grid.axes()
    x, y, z = np.meshgrid(xs, ys, zs, indexing="ij")
    r = np.sqrt(x**2 + y**2 + z**2)
    cube = (0.8 * omega0 * np.exp(-(r - 1.0) / 0.5)).astype(np.float32)
    table = pack_trace_table(jnp.asarray(cube), grid)
    res = trace_rays(table, grid, freq, start, kdir, 1e-3, 200, 10,
                     trace_crosssections=True, record_k=True)
    np.testing.assert_allclose(np.asarray(res.k_record)[-1],
                               np.asarray(res.final_state)[:, 3:6],
                               rtol=1e-6)
    # default stays None (no extra record memory unless asked)
    res0 = trace_rays(table, grid, freq, start, kdir, 1e-3, 40, 10)
    assert res0.k_record is None


@pytest.mark.parametrize("n_steps,stride", [(50, 10), (47, 10), (12, 4)])
def test_record_schedule(n_steps, stride):
    """Record i is taken after step 1 + i*stride, ceil(n_steps/stride)
    records in all (the reference's i % stride == 0 schedule), on a
    refracting scene so that every step moves the rays differently."""
    grid = UniformGrid.cube(2.0, 25)
    xs, ys, zs = grid.axes()
    x, y, z = np.meshgrid(xs, ys, zs, indexing="ij")
    r = np.sqrt(x * x + y * y + z * z)
    table = pack_trace_table(
        jnp.asarray((1e9 * np.exp(-(r - 1.0) / 0.5)).astype(np.float32)),
        grid)
    start = np.array([[0.3, -0.2, 1.9], [1.2, 0.4, 1.9]], np.float32)
    kdir = np.tile(np.array([[0.0, 0.0, -1.0]], np.float32), (2, 1))
    every = trace_rays(table, grid, 150e6, start, kdir, 5e-3, n_steps, 1,
                       trace_crosssections=True)
    strided = trace_rays(table, grid, 150e6, start, kdir, 5e-3, n_steps,
                         stride, trace_crosssections=True)
    n_rec = -(-n_steps // stride)
    assert strided.r_record.shape == (n_rec, 2, 3)
    # stride-1 record j is after step 1 + j
    want = np.asarray(every.r_record)[::stride]
    np.testing.assert_allclose(np.asarray(strided.r_record), want,
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(np.asarray(strided.s_record),
                               np.asarray(every.s_record)[::stride],
                               rtol=1e-5)
