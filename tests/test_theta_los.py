"""theta_mode='los': per-voxel theta(B, k̂) and signed Stokes-V maps
(BASELINE config 4).

The reference hardwires Parms[4] = 90 deg (resample_with_ray_tracing.py:
489-501); this framework additionally samples the B *vector* along rays
and feeds per-voxel theta to the transfer. Tests:

  * the spherical->image-frame B rotation against an analytic dipole,
  * V-map antisymmetry across the magnetic equator on a dipole scene
    (B_z flips sign under y -> -y, so cos(theta(B, k̂)) flips and the
    O/X handedness swap must mirror the V map),
  * theta_mode='los' with zero B vector reduces exactly to the
    theta = 90 'fixed' behavior (regression for strict reference parity),
  * theta_mode='los' sharded over a device mesh matches one device.
"""

import numpy as np
import pytest

from raytracinggrff_jax.grids import UniformGrid
from raytracinggrff_jax.pipeline import (RayEmissionConfig,
                                         _bvec_image_cubes,
                                         run_ray_tracing_emission)


def _dipole_cubes(grid, b0=4.0, extra_bvec=True):
    """Analytic scene: Newkirk-like symmetric corona + dipole field with
    moment along the image +y axis (the MAS polar axis)."""
    import jax.numpy as jnp
    xs, ys, zs = grid.axes()
    x, y, z = np.meshgrid(xs, ys, zs, indexing="ij")
    r = np.sqrt(x * x + y * y + z * z)
    rs = np.maximum(r, 0.9)
    ne = np.where(r >= 1.0, 4.2e4 * 10 ** (4.32 / rs), 0.0).astype(np.float32)
    omega_pe = 8.93e3 * np.sqrt(ne) * 2 * np.pi
    # dipole: B = (m/r^3) (3 (m̂.r̂) r̂ - m̂), m̂ = ŷ
    c = b0 / rs ** 3
    yr = y / np.maximum(r, 1e-9)
    bx = c * 3 * yr * x / np.maximum(r, 1e-9)
    by = c * (3 * yr * yr - 1.0)
    bz = c * 3 * yr * z / np.maximum(r, 1e-9)
    bmag = np.sqrt(bx * bx + by * by + bz * bz).astype(np.float32)
    cubes = {
        "omega_pe": jnp.asarray(omega_pe.astype(np.float32)),
        "ne": jnp.asarray(ne),
        "te": jnp.asarray(np.full_like(ne, 1.4e6)),
        "b": jnp.asarray(bmag),
    }
    if extra_bvec:
        cubes["bvec"] = tuple(jnp.asarray(v.astype(np.float32))
                              for v in (bx, by, bz))
    return cubes


def test_bvec_image_cubes_dipole():
    """Rotating spherical dipole components (br, bt, bp) into the image
    frame must reproduce the Cartesian dipole field."""
    grid = UniformGrid.cube(2.0, 24)
    xs, ys, zs = grid.axes()
    x, y, z = np.meshgrid(xs, ys, zs, indexing="ij")
    r = np.maximum(np.sqrt(x * x + y * y + z * z), 1e-9)
    m = 3.0
    # spherical components about the MAS polar axis (= image +y):
    # colat theta measured from +y, br = 2m cos/r^3, bt = m sin/r^3, bp = 0
    cos_t = y / r
    sin_t = np.sqrt(np.maximum(1.0 - cos_t * cos_t, 0.0))
    br = 2 * m * cos_t / r ** 3
    bt = m * sin_t / r ** 3
    bp = np.zeros_like(br)
    got = _bvec_image_cubes(br.astype(np.float32), bt.astype(np.float32),
                            bp.astype(np.float32), grid)
    c = m / r ** 3
    want = (c * 3 * cos_t * x / r,
            c * (3 * cos_t * cos_t - 1.0),
            c * 3 * cos_t * z / r)
    # exclude the polar axis (rho ~ 0: bt direction degenerate) and the
    # origin-adjacent nodes where 1/r^3 amplifies rounding
    rho = np.sqrt(x * x + z * z)
    ok = (rho > 2 * grid.dx) & (r > 0.5)
    assert ok.sum() > 1000
    for g, w in zip(got, want):
        np.testing.assert_allclose(np.asarray(g)[ok], w[ok],
                                   rtol=2e-4, atol=2e-4 * m)


_COMMON = dict(n_pix=8, x_fov=1.3, freq_hz=150e6, grid_n=40,
               grid_extent=2.5, z_observer=2.5, dt=1e-2, n_steps=610,
               record_stride=10, nfreq=2, freq_log_step=0.2)


@pytest.fixture(scope="module")
def dipole_cubes():
    return _dipole_cubes(UniformGrid.cube(2.5, 40))


def test_stokes_v_antisymmetric_across_equator(dipole_cubes):
    """V/I must flip sign under y -> -y (B_z is odd in y for a dipole with
    moment in the plane of sky), and be nonzero at a few-G field."""
    res = run_ray_tracing_emission(
        cubes=dipole_cubes, verbose=False,
        config=RayEmissionConfig(theta_mode="los",
                                 **_COMMON))
    tb = res["emission_cube"]
    pol = res["emission_polVI_cube"]
    lit = tb > 1e4
    lit_sym = lit & lit[::-1]          # pixel and its y-mirror both lit
    assert lit_sym.sum() > 20
    # the emission itself is y-symmetric (scene is) ...
    np.testing.assert_allclose(tb[lit_sym], tb[::-1][lit_sym], rtol=2e-2)
    # ... and the polarization is y-ANTIsymmetric and genuinely nonzero
    v = pol[lit_sym]
    v_mirror = pol[::-1][lit_sym]
    assert np.max(np.abs(v)) > 1e-4
    np.testing.assert_allclose(v_mirror, -v, atol=5e-4)


def test_theta_los_zero_b_matches_fixed(dipole_cubes):
    """With a zero B vector, cos(theta) = 0 everywhere -> theta = 90 deg,
    which must reproduce the reference-parity 'fixed' path exactly."""
    import jax.numpy as jnp
    cubes0 = dict(dipole_cubes)
    z = jnp.zeros_like(cubes0["ne"])
    cubes0["bvec"] = (z, z, z)
    cfg_fixed = RayEmissionConfig(theta_mode="fixed",
                                  **_COMMON)
    cfg_los = RayEmissionConfig(theta_mode="los",
                                **_COMMON)
    r_fixed = run_ray_tracing_emission(cubes=dipole_cubes, verbose=False,
                                       config=cfg_fixed)
    r_los = run_ray_tracing_emission(cubes=cubes0, verbose=False,
                                     config=cfg_los)
    np.testing.assert_allclose(r_los["emission_cube"],
                               r_fixed["emission_cube"], rtol=1e-6)
    np.testing.assert_allclose(r_los["emission_polVI_cube"],
                               r_fixed["emission_polVI_cube"], atol=1e-6)


def test_theta_los_sharded_matches_single_device(dipole_cubes):
    """theta_mode='los' over a (4, 2) mesh: the B-vector table is
    replicated, the wave-vector records shard with the rays, and the
    signed V/I map matches one device."""
    import jax
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    from raytracinggrff_jax.parallel.mesh import make_mesh
    cfg = RayEmissionConfig(theta_mode="los", **_COMMON)
    one = run_ray_tracing_emission(cubes=dipole_cubes, verbose=False,
                                   config=cfg)
    got = run_ray_tracing_emission(cubes=dipole_cubes, verbose=False,
                                   config=cfg, mesh=make_mesh(4, 2))
    np.testing.assert_allclose(got["emission_cube"], one["emission_cube"],
                               rtol=1e-5, atol=1e-3)
    np.testing.assert_allclose(got["emission_polVI_cube"],
                               one["emission_polVI_cube"], atol=1e-6)
    assert np.max(np.abs(one["emission_polVI_cube"])) > 1e-4
