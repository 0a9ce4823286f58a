"""What only a GPU run can show: the compiled maps against the CPU backend
and the float64 oracle. Marked `gpu`: skipped unless RTGRFF_GPU_TESTS=1
(chip_smoke.py runs them in-process on the card).

Scenes are small (40^3 cube, 16^2 rays, 310 steps) so each compiles in
seconds. Tolerances follow raytracinggrff_jax.utils.parity: free-free
pixels tight, gyroresonance-sensitive pixels by median and max.
"""

import numpy as np
import pytest

from raytracinggrff_jax.grids import UniformGrid
from raytracinggrff_jax.pipeline import (RayEmissionConfig,
                                         run_ray_tracing_emission)
from raytracinggrff_jax.utils.parity import compare_tb, format_checks

pytestmark = pytest.mark.gpu

_COMMON = dict(n_pix=16, x_fov=1.3, freq_hz=150e6, grid_n=40,
               grid_extent=2.5, z_observer=2.5, dt=1e-2, n_steps=310,
               record_stride=10, s_input_on=True)


def _dipole_cubes(moment):
    """Newkirk corona + a dipole along the image y axis (the MAS polar
    axis): the LOS component Bz = 3yz/r^5 flips sign across y = 0."""
    import jax.numpy as jnp
    grid = UniformGrid.cube(2.5, 40)
    xs, ys, zs = grid.axes()
    x, y, z = np.meshgrid(xs, ys, zs, indexing="ij")
    r = np.sqrt(x * x + y * y + z * z)
    ne = np.where(r >= 1.0, 4.2e4 * 10 ** (4.32 / np.maximum(r, 0.9)),
                  0.0).astype(np.float32)
    rs = np.maximum(r, 0.9)
    bx = (moment * 3 * x * y / rs ** 5).astype(np.float32)
    by = (moment * (2 * y * y - x * x - z * z) / rs ** 5).astype(np.float32)
    bz = (moment * 3 * z * y / rs ** 5).astype(np.float32)
    bmag = np.sqrt(bx ** 2 + by ** 2 + bz ** 2).astype(np.float32)
    return {
        "omega_pe": jnp.asarray(8.93e3 * np.sqrt(ne) * 2 * np.pi),
        "ne": jnp.asarray(ne),
        "te": jnp.asarray(np.full_like(ne, 1.4e6)),
        "b": jnp.asarray(bmag),
        "bvec": (jnp.asarray(bx), jnp.asarray(by), jnp.asarray(bz)),
    }


def _run_on(device, cubes, **cfg):
    import jax
    with jax.default_device(device):
        local = jax.device_put(cubes, device)
        return run_ray_tracing_emission(
            cubes=local, verbose=False,
            config=RayEmissionConfig(**{**_COMMON, **cfg}))


def test_theta_los_signed_vi_map(gpu_device):
    """theta_mode='los' on the card: a dipole field gives a signed V/I map
    with both polarities, and T_b stays within 5 % of the theta = 90 run
    (quiet-Sun free-free V is a percent-level perturbation)."""
    cubes = _dipole_cubes(2.0)
    r_los = _run_on(gpu_device, cubes, theta_mode="los")
    r_fix = _run_on(gpu_device, cubes, theta_mode="fixed")
    vi = r_los["emission_polVI_cube"]
    tb_los, tb_fix = r_los["emission_cube"], r_fix["emission_cube"]
    lit = (tb_los > 1e4) & (tb_fix > 1e4)
    assert lit.sum() > 80
    assert np.isfinite(vi).all()
    assert (vi[lit] > 1e-5).any() and (vi[lit] < -1e-5).any()
    np.testing.assert_allclose(tb_los[lit], tb_fix[lit], rtol=0.05)


def test_mechanism_sweep_map_matches_cpu(gpu_device, cpu_device):
    """mechanism 1+2+4, gaunt='exact', theta_mode='los' on the card against
    the same program on the CPU. The dipole is scaled so the s = 2..4
    gyroresonance layers of a 150 MHz wave (18-27 G) sit in the corona."""
    cubes = _dipole_cubes(40.0)
    flags = dict(theta_mode="los", gaunt="exact")
    got = _run_on(gpu_device, cubes, mechanism=1 + 2 + 4, **flags)
    want = _run_on(cpu_device, cubes, mechanism=1 + 2 + 4, **flags)
    ff_only = _run_on(cpu_device, cubes, mechanism=1 + 4, **flags)
    a = want["emission_cube"]
    gr_effect = (np.abs(ff_only["emission_cube"] - a)
                 / np.maximum(a, 1.0))
    st = compare_tb(got["emission_cube"], a, gr_effect=gr_effect)
    print(format_checks(st, "GR map GPU vs CPU"))
    # the scene exercises both classes
    assert st["n_ff"] > 40 and st["n_gr"] > 40
    assert st["ok"]
    # V/I on the free-free pixels at the tolerance it held across backends
    # before (the GR-sensitive ones move with their T_b)
    ff = (a > 1e4) & (gr_effect <= 1e-3)
    np.testing.assert_allclose(got["emission_polVI_cube"][ff],
                               want["emission_polVI_cube"][ff], atol=1e-4)


def test_dem_parity_on_gpu(gpu_device):
    """DEM free-free on the card against the float64 quadrature oracle, at
    the CPU test's tolerance: the moment products run at HIGHEST, not
    TF32."""
    import jax
    from raytracinggrff_jax.grff.transfer import get_mw
    from test_native_grff import _dem_case, _dem_oracle
    t_grid, dem, parms, lparms, rparms = _dem_case()
    with jax.default_device(gpu_device):
        rl = get_mw(lparms, rparms, parms, t=t_grid, dem=dem)
    for m_i, flux in _dem_oracle(t_grid, dem, parms, lparms,
                                 rparms).items():
        np.testing.assert_allclose(rl[m_i], flux, rtol=2e-3,
                                   err_msg=f"mode RL[{m_i}]")
