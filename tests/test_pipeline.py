"""End-to-end pipeline tests on a synthetic MAS model (no external data).

Physics sanity anchor (BASELINE.md): quiet-Sun T_b should land in the
0.1-2 MK range at metric wavelengths for a ~1.4 MK corona."""

import numpy as np
import pytest

from raytracinggrff_jax.mas.model import synthetic_mas_model
from raytracinggrff_jax.pipeline import (
    RayEmissionConfig, resample_mas_los, run_ray_tracing_emission,
    synthetic_ff)


@pytest.fixture(scope="module")
def corona(tmp_path_factory):
    path = tmp_path_factory.mktemp("model") / "corona"
    synthetic_mas_model(path, nphi=36, ntheta=25, nr=40)
    return path


def test_straight_los_pipeline(corona, tmp_path):
    los = resample_mas_los(corona, n_pix=16, n_z=80, dz0=2e-3,
                           phi0_offset=0.0, verbose=False,
                           out_path=tmp_path / "LOS_data.npz")
    assert los["Ne_LOS"].shape == (16, 16, 80)
    # on-disk center pixel: starts at surface, all valid
    ne_c = los["Ne_LOS"][8, 8]
    assert np.all(np.isfinite(ne_c))
    assert ne_c[0] > 1e7  # near-surface Newkirk density
    # monotonically decreasing outward (modulo modulation)
    assert ne_c[-1] < ne_c[0]
    # saved npz has the reference keys
    data = np.load(tmp_path / "LOS_data.npz")
    for key in ("Ne_LOS", "Te_LOS", "B_LOS", "ds_LOS",
                "x_coords", "y_coords", "z_coords"):
        assert key in data

    emission = synthetic_ff(los, 300e6, 2, 0.2, verbose=False)
    tb = emission["emission_cube"]
    assert tb.shape == (16, 16, 2)
    center_tb = tb[8, 8, 0]
    # optically thick metric corona: T_b of order the coronal temperature
    assert 1e5 < center_tb < 3e6


def test_ray_tracing_emission_pipeline(corona, tmp_path):
    # enough steps for on-disk rays to reach the reflection layer and come
    # back out of the corona (path ~ n_steps*dt*C_R ~ 4 R_sun)
    cfg = RayEmissionConfig(
        n_pix=8, x_fov=1.44, freq_hz=150e6, grid_n=48, grid_extent=2.5,
        z_observer=2.5, dt=1e-2, n_steps=900, record_stride=10,
        s_input_on=False, nfreq=1)
    out = tmp_path / "ray_emission.npz"
    result = run_ray_tracing_emission(model_path=corona, config=cfg,
                                      out_path=out, verbose=False)
    tb = result["emission_cube"]
    assert tb.shape == (8, 8, 1)
    assert np.all(np.isfinite(tb))
    # on-disk pixels should be bright, ~coronal temperature (optically thick).
    # The 4 exact-center near-radial rays can tunnel through the coarse
    # (grid_n=48) reflection layer and are excluded — the reference has the
    # same under-resolution behavior at coarse grid_n.
    on_disk = tb[[2, 2, 5, 5], [2, 5, 2, 5], 0]
    assert np.all(on_disk > 5e5)
    # limb/off-disk pixels dimmer than disk
    assert np.all(tb[0, :, 0] < on_disk.min())
    data = np.load(out)
    for key in ("emission_cube", "emission_polVI_cube", "frequencies_Hz",
                "x_coords", "y_coords"):
        assert key in data
    # x_coords in meters spanning the FOV
    np.testing.assert_allclose(data["x_coords"][-1], 1.44 * 6.957e8,
                               rtol=1e-6)


def test_s_input_on_changes_map(corona):
    common = dict(n_pix=6, x_fov=1.2, freq_hz=150e6, grid_n=40,
                  grid_extent=2.5, z_observer=2.5, dt=1e-2, n_steps=300,
                  record_stride=10, nfreq=1)
    cubes = None
    from raytracinggrff_jax.grids import UniformGrid
    from raytracinggrff_jax.mas.model import MASModel
    from raytracinggrff_jax.pipeline import prepare_cubes
    grid = UniformGrid.cube(2.5, 40)
    cubes = prepare_cubes(MASModel(corona), grid, 0.0, verbose=False)
    r_off = run_ray_tracing_emission(cubes=cubes, verbose=False,
                                     config=RayEmissionConfig(
                                         s_input_on=False, **common))
    r_on = run_ray_tracing_emission(cubes=cubes, verbose=False,
                                    config=RayEmissionConfig(
                                        s_input_on=True, **common))
    a = r_off["emission_cube"]
    b = r_on["emission_cube"]
    assert np.all(np.isfinite(a)) and np.all(np.isfinite(b))
    # S input rescales the effective emitting area -> maps differ somewhere
    assert not np.allclose(a, b)


def test_polar_cuts_and_plot(corona, tmp_path):
    """plot_model.py capability: equatorial + meridional polar cuts off the
    native MAS mesh, with the reference's phi=0-vs-180 tie-break."""
    from raytracinggrff_jax.cli.plot_model_slices import main, polar_cuts
    from raytracinggrff_jax.mas.model import MASModel

    var = MASModel(corona)["rho"]
    cuts = polar_cuts(var, r_max=3.0)
    eq, phi, r_eq = cuts["eq"]
    mer, theta, r_mer = cuts["mer"]
    assert eq.shape == (len(phi), len(r_eq))
    assert mer.shape == (len(theta), len(r_mer))
    assert r_eq.max() <= 3.0
    assert np.all(eq > 0)
    # the synthetic model's density falls off with r everywhere
    assert np.all(np.diff(np.median(eq, axis=0)) < 0)
    # the cut sits on whichever of phi=0/180 the mesh lands closer to
    assert (abs(cuts["phi_cut_deg"]) < 20.0
            or abs(cuts["phi_cut_deg"] - 180.0) < 20.0)

    out = tmp_path / "polar.png"
    rc = main(["-m", str(corona), "--polar", "-o", str(out)])
    assert rc == 0 and out.exists()


def test_per_step_s_mode_runs_through_pipeline(corona):
    """s_mode='per_step' (the CPU reference's instantaneous S,
    build_rays.py:241-244) runs on the one pipeline path and, with the S
    input on, gives another finite map than the cumulative default."""
    common = dict(n_pix=6, x_fov=1.2, freq_hz=150e6, grid_n=40,
                  grid_extent=2.5, z_observer=2.5, dt=1e-2, n_steps=300,
                  record_stride=10, nfreq=1, s_input_on=True)
    from raytracinggrff_jax.grids import UniformGrid
    from raytracinggrff_jax.mas.model import MASModel
    from raytracinggrff_jax.pipeline import prepare_cubes
    cubes = prepare_cubes(MASModel(corona), UniformGrid.cube(2.5, 40), 0.0,
                          verbose=False)
    per = run_ray_tracing_emission(cubes=cubes, verbose=False,
                                   config=RayEmissionConfig(
                                       s_mode="per_step", **common))
    cum = run_ray_tracing_emission(cubes=cubes, verbose=False,
                                   config=RayEmissionConfig(**common))
    a, b = per["emission_cube"], cum["emission_cube"]
    assert a.shape == (6, 6, 1) and np.isfinite(a).all()
    assert (a > 1e4).any()
    assert not np.allclose(a, b)
