"""Multi-device sharding: the pipeline partitioned over a virtual 8-CPU mesh
must reproduce the single-device run, with every ray-axis array split."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from raytracinggrff_jax.grids import UniformGrid
from raytracinggrff_jax.pipeline import (RayEmissionConfig,
                                         run_ray_tracing_emission)
from raytracinggrff_jax.parallel.mesh import make_mesh, replicate, shard_rays
from raytracinggrff_jax.sampler import pack_model_table, sample_model_with_rays
from raytracinggrff_jax.tracer import pack_trace_table, trace_rays


@pytest.fixture(autouse=True)
def _eight_devices():
    # decided when a test runs, not at import (every xdist worker must
    # collect the same tests)
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")


def _scene(n_rays=64, grid_n=25):
    grid = UniformGrid.cube(2.0, grid_n)
    xs, ys, zs = grid.axes()
    x, y, z = np.meshgrid(xs, ys, zs, indexing="ij")
    r = np.sqrt(x * x + y * y + z * z)
    omega_pe = (1e9 * np.exp(-(r - 1.0) / 0.5)).astype(np.float32)
    rng = np.random.default_rng(0)
    start = np.column_stack([
        rng.uniform(-1.0, 1.0, n_rays), rng.uniform(-1.0, 1.0, n_rays),
        np.full(n_rays, 1.9)]).astype(np.float32)
    kdir = np.tile(np.array([[0, 0, -1]], np.float32), (n_rays, 1))
    return grid, omega_pe, start, kdir


def test_sharded_trace_matches_single_device():
    grid, omega_pe, start, kdir = _scene()
    table = pack_trace_table(jnp.asarray(omega_pe), grid)

    res_single = trace_rays(table, grid, 150e6, jnp.asarray(start),
                            jnp.asarray(kdir), 5e-3, 50, 10,
                            trace_crosssections=True)

    mesh = make_mesh(n_ray_shards=8, n_freq_shards=1)
    start_s = shard_rays(jnp.asarray(start), mesh)
    kdir_s = shard_rays(jnp.asarray(kdir), mesh)
    table_r = replicate(table, mesh)
    res_sharded = trace_rays(table_r, grid, 150e6, start_s, kdir_s,
                             5e-3, 50, 10, trace_crosssections=True)

    np.testing.assert_allclose(np.asarray(res_single.r_record),
                               np.asarray(res_sharded.r_record),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(np.asarray(res_single.s_record),
                               np.asarray(res_sharded.s_record),
                               rtol=1e-5, atol=1e-6)
    # output actually sharded over rays
    shard_axes = {s.index[1] for s in res_sharded.r_record.addressable_shards}
    assert len(shard_axes) == 8


def test_mesh_shapes():
    mesh = make_mesh(n_ray_shards=4, n_freq_shards=2)
    assert mesh.devices.shape == (4, 2)
    assert mesh.axis_names == ("rays", "freq")
    with pytest.raises(ValueError):
        make_mesh(n_ray_shards=3, n_freq_shards=2)


def test_graft_entry_single_and_multichip():
    import importlib.util
    import pathlib
    spec = importlib.util.spec_from_file_location(
        "graft_entry",
        pathlib.Path(__file__).resolve().parents[1] / "__graft_entry__.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)

    fn, args = mod.entry()
    out = jax.jit(fn)(*args)
    assert np.all(np.isfinite(np.asarray(out)))

    mod.dryrun_multichip(8)


def _newkirk_cubes(n=40, extent=2.5):
    grid = UniformGrid.cube(extent, n)
    xs, ys, zs = grid.axes()
    x, y, z = np.meshgrid(xs, ys, zs, indexing="ij")
    r = np.sqrt(x * x + y * y + z * z)
    ne = np.where(r >= 1.0, 4.2e4 * 10 ** (4.32 / np.maximum(r, 0.9)),
                  0.0).astype(np.float32)
    return {
        "omega_pe": jnp.asarray(8.93e3 * np.sqrt(ne) * 2 * np.pi),
        "ne": jnp.asarray(ne),
        "te": jnp.asarray(np.full_like(ne, 1.4e6)),
        "b": jnp.asarray((2.0 / np.maximum(r, 0.9) ** 3).astype(np.float32)),
    }


@pytest.mark.parametrize("shape", [(8, 1), (4, 2)])
def test_pipeline_sharded_matches_single_device(shape):
    """run_ray_tracing_emission over a (rays, freq) mesh reproduces the
    one-device map, and the sampled LOS arrays stay split over 'rays'
    (none lands whole on one device)."""
    cfg = RayEmissionConfig(n_pix=8, x_fov=1.3, freq_hz=150e6, grid_n=40,
                            grid_extent=2.5, z_observer=2.5, dt=1e-2,
                            n_steps=310, record_stride=10, nfreq=2,
                            freq_log_step=0.2, s_input_on=True)
    cubes = _newkirk_cubes()
    one = run_ray_tracing_emission(cubes=cubes, verbose=False, config=cfg)
    mesh = make_mesh(*shape)
    got = run_ray_tracing_emission(cubes=cubes, verbose=False, config=cfg,
                                   mesh=mesh)
    np.testing.assert_allclose(got["emission_cube"], one["emission_cube"],
                               rtol=1e-5, atol=1e-3)
    np.testing.assert_allclose(got["emission_polVI_cube"],
                               one["emission_polVI_cube"], atol=1e-5)
    assert (one["emission_cube"] > 1e4).sum() > 20
    for name in ("ne", "te", "b", "ds", "valid_mask", "s"):
        arr = getattr(got["_sampled"], name)
        assert arr.sharding.shard_shape(arr.shape)[1] == 64 // shape[0], name


def test_ensure_devices_raises_instead_of_rebuilding():
    """Too few devices is an error: the backend is not torn down and
    rebuilt as a larger CPU platform."""
    import importlib.util
    import pathlib
    spec = importlib.util.spec_from_file_location(
        "graft_entry",
        pathlib.Path(__file__).resolve().parents[1] / "__graft_entry__.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    before = jax.devices()
    with pytest.raises(RuntimeError, match="need 16 devices"):
        mod.dryrun_multichip(16)
    assert jax.devices() == before
