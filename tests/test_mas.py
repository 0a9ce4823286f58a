"""MAS I/O and spherical sampling: HDF4 round-trip, axis identification,
unit conversion, interpolation accuracy, cube resampling conventions."""

import numpy as np
import pytest

from raytracinggrff_jax.constants import MAS_UNITS
from raytracinggrff_jax.grids import UniformGrid
from raytracinggrff_jax.mas.hdf4 import read_hdf4_sds, write_hdf4_sds
from raytracinggrff_jax.mas.model import (
    MASModel, MASVariable, resample_var_to_cube, synthetic_mas_model)


def test_hdf4_roundtrip(tmp_path):
    rng = np.random.default_rng(0)
    data = rng.normal(size=(6, 5, 4)).astype(np.float32)
    scales = [np.linspace(0, 2 * np.pi, 6, endpoint=False),
              np.linspace(0.1, np.pi - 0.1, 5),
              1.0 + np.linspace(0, 3, 4)]
    p = tmp_path / "rho002.hdf"
    write_hdf4_sds(p, data, scales=scales, label="rho")
    sds = read_hdf4_sds(p)[0]
    np.testing.assert_allclose(sds.data, data, rtol=1e-7)
    for s, ref in zip(sds.scales, scales):
        np.testing.assert_allclose(s, ref, rtol=1e-12)
    assert sds.label == "rho"


def test_hdf4_float64_and_no_scales(tmp_path):
    data = np.arange(24, dtype=np.float64).reshape(2, 3, 4)
    p = tmp_path / "x.hdf"
    write_hdf4_sds(p, data)
    sds = read_hdf4_sds(p)[0]
    np.testing.assert_allclose(sds.data, data)
    assert all(s is None for s in sds.scales)


def test_synthetic_model_discovery_and_units(tmp_path):
    path = synthetic_mas_model(tmp_path / "corona", nphi=16, ntheta=13, nr=48)
    model = MASModel(path)
    assert set(model.variables) == {"rho", "t", "br", "bt", "bp"}
    assert model.temperature_variable() == "t"
    rho = model["rho"]
    # sampled density at r=1.5 on the equator ~ Newkirk value (cm^-3)
    v = np.asarray(rho.sample_sph(np.float32(1.5), np.float32(np.pi / 2),
                                  np.float32(0.0)))
    expected = 4.2e4 * 10 ** (4.32 / 1.5) * 1.3  # modulation cos(0)=1
    np.testing.assert_allclose(v, expected, rtol=0.05)


def test_axis_identification_any_order(tmp_path):
    """Axes are found by value ranges regardless of storage order."""
    phi = np.linspace(0, 2 * np.pi, 10, endpoint=False)
    theta = np.linspace(0.05, np.pi - 0.05, 7)
    r = np.linspace(1.0, 4.0, 9)
    P, T, R = np.meshgrid(phi, theta, r, indexing="ij")
    vals = np.cos(T) / R ** 2
    # store transposed (r, theta, phi)
    p = tmp_path / "br002.hdf"
    write_hdf4_sds(p, np.transpose(vals, (2, 1, 0)).astype(np.float32),
                   scales=[r, theta, phi])
    var = MASVariable.from_file(p, "br")
    q = np.asarray(var.sample_sph(np.float32(2.0), np.float32(0.4),
                                  np.float32(1.0)))
    np.testing.assert_allclose(q, MAS_UNITS["br"] * np.cos(0.4) / 4.0,
                               rtol=5e-3)


def test_sample_sph_periodic_phi(tmp_path):
    phi = np.linspace(0, 2 * np.pi, 24, endpoint=False)
    theta = np.linspace(0.05, np.pi - 0.05, 9)
    r = np.linspace(1.0, 3.0, 8)
    P, _, _ = np.meshgrid(phi, theta, r, indexing="ij")
    vals = np.cos(P)
    var = MASVariable("x", vals, phi, theta, r, unit_factor=1.0)
    # query just past the last phi point: wraps through the padded column
    q = np.asarray(var.sample_sph(
        np.float32(2.0), np.float32(np.pi / 2),
        np.float32(2 * np.pi - 0.05)))
    np.testing.assert_allclose(q, np.cos(-0.05), rtol=2e-2)


def test_sample_sph_r_out_of_bounds_nan():
    phi = np.linspace(0, 2 * np.pi, 8, endpoint=False)
    theta = np.linspace(0.1, np.pi - 0.1, 5)
    r = np.linspace(1.0, 3.0, 6)
    var = MASVariable("x", np.ones((8, 5, 6)), phi, theta, r, unit_factor=1.0)
    v = np.asarray(var.sample_sph(np.float32([0.5, 3.5, 2.0]),
                                  np.full(3, np.pi / 2, np.float32),
                                  np.zeros(3, np.float32)))
    assert np.isnan(v[0]) and np.isnan(v[1]) and np.isfinite(v[2])


def test_resample_cube_conventions(tmp_path):
    """The (x,-z,y)+phi0 orientation: a density spike at MAS lon=phi0 on the
    equator must appear along the image +x axis (z=0 plane, y=0)."""
    phi = np.linspace(0, 2 * np.pi, 72, endpoint=False)
    theta = np.linspace(0.05, np.pi - 0.05, 31)
    r = np.linspace(1.0, 4.0, 40)
    P, T, _ = np.meshgrid(phi, theta, r, indexing="ij")
    phi0 = 24.0
    # bump centered at lon = phi0 deg, equator
    vals = np.exp(-((np.mod(P - np.deg2rad(phi0) + np.pi, 2 * np.pi)
                     - np.pi) ** 2) / 0.1) * np.exp(-(T - np.pi / 2) ** 2 / 0.1)
    var = MASVariable("rho", vals, phi, theta, r, unit_factor=1.0)
    grid = UniformGrid.cube(2.0, 21)
    cube = np.asarray(resample_var_to_cube(var, grid,
                                           phi0_offset_deg=phi0, fill_nan=0.0))
    # image point (x=1.5, y=0, z=0): MAS coords r=1.5, colat from -z=0 ->
    # equator, lon = atan2(y=..., x)+phi0. For image (1.5,0,0):
    # cart_to_sph(1.5, 0, 0) -> lon=0+phi0=phi0 -> at the bump.
    ix = np.argmin(np.abs(grid.axes()[0] - 1.5))
    iy = np.argmin(np.abs(grid.axes()[1] - 0.0))
    iz = np.argmin(np.abs(grid.axes()[2] - 0.0))
    assert cube[ix, iy, iz] > 0.8
    # opposite side should be near zero
    ix2 = np.argmin(np.abs(grid.axes()[0] + 1.5))
    assert cube[ix2, iy, iz] < 0.1
    # inside the sun -> fill value
    ic = np.argmin(np.abs(grid.axes()[0]))
    assert cube[ic, iy, iz] == 0.0


def test_missing_variable_raises(tmp_path):
    path = tmp_path / "empty"
    path.mkdir()
    model = MASModel(path)
    with pytest.raises(KeyError):
        model["rho"]


def test_multi_timestep_selection(tmp_path):
    """A directory with several {var}NNN files is a time series: timestep
    selects the file, at_time() iterates (ref concatenates along time,
    build_rays.py:48-66)."""
    path = synthetic_mas_model(tmp_path / "corona", nphi=16, ntheta=13,
                               nr=24, timestep=1)
    synthetic_mas_model(path, nphi=16, ntheta=13, nr=24, timestep=2,
                        b0_gauss=5.0)
    model = MASModel(path)
    assert model.n_timesteps("br") == 2
    b_t0 = model["br"].data
    b_t1 = model.at_time(1)["br"].data
    np.testing.assert_allclose(np.abs(b_t1).max(),
                               2.0 * np.abs(b_t0).max(), rtol=1e-6)
    # rho is identical across the two steps
    np.testing.assert_allclose(model.at_time(1)["rho"].data,
                               model["rho"].data)
    with pytest.raises(IndexError):
        MASModel(path, timestep=2)["rho"]
