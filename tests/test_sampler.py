"""LOS sampler contracts, modeled on the reference test fixture
(tests/test_gpu_raytrace.py:13-110): linear-field exactness, fill values,
valid-mask propagation, and ds anchoring across invalid gaps."""

import numpy as np

from raytracinggrff_jax.sampler import sample_model_with_rays_arrays


def _make_synth_case(seed=0):
    rng = np.random.default_rng(seed)
    nx = ny = nz = 33
    xg = np.linspace(-1.0, 1.0, nx, dtype=np.float32)
    yg = np.linspace(-1.0, 1.0, ny, dtype=np.float32)
    zg = np.linspace(-1.0, 1.0, nz, dtype=np.float32)
    x, y, z = np.meshgrid(xg, yg, zg, indexing="ij")
    ne = (x + y + z).astype(np.float32)
    te = (x * x + 2.0 * y + 3.0 * z).astype(np.float32)
    b = (2.0 * x - y + 0.5 * z).astype(np.float32)

    n_steps, n_rays = 64, 128
    origin = rng.uniform(-0.8, 0.8, size=(n_rays, 3)).astype(np.float32)
    dirs = rng.normal(size=(n_rays, 3)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    s = (np.arange(n_steps, dtype=np.float32) * 0.03)[:, None]
    r_record = origin[None, :, :] + s[:, :, None] * dirs[None, :, :]

    s_arr = np.ones((n_steps, n_rays), dtype=np.float32)
    s_arr[::9, ::7] = 0.0
    s_arr[::13, ::11] = np.nan
    r_record[-5:, :8, 0] = 2.5  # force some out-of-bounds points
    return xg, yg, zg, ne, te, b, r_record, s_arr, origin.copy()


def _reference_ds(positions, valid_mask, ray_start, r_sun_cm):
    """Straight NumPy port of the documented ds contract
    (gpu_raytrace.py:473-486), used as ground truth."""
    n_steps, n_rays, _ = positions.shape
    ds = np.zeros((n_steps, n_rays), dtype=np.float32)
    for r in range(n_rays):
        idx = np.flatnonzero(valid_mask[:, r])
        if idx.size == 0:
            continue
        p = positions[idx, r, :]
        d = np.empty(idx.size, dtype=np.float32)
        d[0] = np.float32(np.linalg.norm(p[0] - ray_start[r]) * r_sun_cm)
        if idx.size > 1:
            d[1:] = (np.linalg.norm(p[1:] - p[:-1], axis=1)
                     * r_sun_cm).astype(np.float32)
        ds[idx, r] = d
    return ds


def test_linear_field_accuracy_and_fills():
    xg, yg, zg, ne, te, b, r_record, s_arr, ray_start = _make_synth_case(1)
    out = sample_model_with_rays_arrays(
        xg, yg, zg, ne, te, b, r_record, s_arr, ray_start, r_sun_cm=1.0)
    valid = np.asarray(out["valid_mask"])
    inb = (
        (r_record[..., 0] >= xg[0]) & (r_record[..., 0] <= xg[-1])
        & (r_record[..., 1] >= yg[0]) & (r_record[..., 1] <= yg[-1])
        & (r_record[..., 2] >= zg[0]) & (r_record[..., 2] <= zg[-1])
    )
    mask = valid & inb
    expected_ne = r_record[..., 0] + r_record[..., 1] + r_record[..., 2]
    np.testing.assert_allclose(np.asarray(out["ne"])[mask],
                               expected_ne[mask], rtol=2e-5, atol=2e-5)
    oob = valid & ~inb
    assert np.any(oob)
    np.testing.assert_allclose(np.asarray(out["ne"])[oob], 0.0)
    np.testing.assert_allclose(np.asarray(out["te"])[oob], 1e4)
    np.testing.assert_allclose(np.asarray(out["b"])[oob], 0.0)


def test_valid_mask_and_shapes():
    xg, yg, zg, ne, te, b, r_record, s_arr, ray_start = _make_synth_case(2)
    out = sample_model_with_rays_arrays(
        xg, yg, zg, ne, te, b, r_record, s_arr, ray_start, r_sun_cm=1.0)
    for key in ("ne", "te", "b", "ds", "valid_mask"):
        assert np.asarray(out[key]).shape == s_arr.shape
    assert np.all(~np.asarray(out["valid_mask"])[::9, ::7])   # s == 0
    assert np.all(~np.asarray(out["valid_mask"])[::13, ::11])  # s == NaN
    assert np.all(np.asarray(out["ds"]) >= 0.0)


def test_ds_matches_reference_contract():
    xg, yg, zg, ne, te, b, r_record, s_arr, ray_start = _make_synth_case(3)
    out = sample_model_with_rays_arrays(
        xg, yg, zg, ne, te, b, r_record, s_arr, ray_start, r_sun_cm=6.957e10)
    valid = np.asarray(out["valid_mask"])
    expected = _reference_ds(r_record.astype(np.float32), valid,
                             ray_start, 6.957e10)
    np.testing.assert_allclose(np.asarray(out["ds"]), expected,
                               rtol=2e-5, atol=1e4)
