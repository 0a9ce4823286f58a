"""Utility-layer tests: NaN patcher, beam convolution, FITS reader."""

import numpy as np
import pytest

from raytracinggrff_jax.utils.beam import gaussian_beam_convolve
from raytracinggrff_jax.utils.fits import load_observation_map, read_fits_image
from raytracinggrff_jax.utils.nanpatch import patch_nan_emission_map


def _reference_patch_2d(a, max_passes=10):
    """Straight port of the documented reference contract
    (raytracingGRFF/util.py:42-77), used as ground truth."""
    a = np.array(a, dtype=np.float64)
    ny, nx = a.shape
    for _ in range(max_passes):
        nan_mask = ~np.isfinite(a)
        if not np.any(nan_mask):
            return a
        rows, cols = np.where(nan_mask)
        fixed = 0
        for i, j in zip(rows, cols):
            neighbors = []
            for jj in range(j - 1, -1, -1):
                if np.isfinite(a[i, jj]):
                    neighbors.append(a[i, jj])
                    break
            for jj in range(j + 1, nx):
                if np.isfinite(a[i, jj]):
                    neighbors.append(a[i, jj])
                    break
            for ii in range(i - 1, -1, -1):
                if np.isfinite(a[ii, j]):
                    neighbors.append(a[ii, j])
                    break
            for ii in range(i + 1, ny):
                if np.isfinite(a[ii, j]):
                    neighbors.append(a[ii, j])
                    break
            if neighbors:
                a[i, j] = np.mean(neighbors)
                fixed += 1
        if fixed == 0:
            break
    return a


def test_nan_patch_matches_reference_contract():
    rng = np.random.default_rng(0)
    a = rng.uniform(1, 2, (12, 12))
    a[3, 4] = np.nan
    a[7, 7] = np.nan
    a[7, 8] = np.nan
    a[0, 0] = np.nan   # corner
    out = patch_nan_emission_map(a)
    ref = _reference_patch_2d(a)
    # exact: the patcher reproduces the reference's sequential in-pass
    # propagation order (adjacent NaNs feed on freshly patched values);
    # tests/test_reference_parity.py A/Bs the same thing against the
    # actual /root/reference implementation
    assert np.all(np.isfinite(out))
    np.testing.assert_array_equal(out, ref)


def test_nan_patch_3d_and_inplace():
    a = np.ones((6, 6, 2))
    a[2, 2, 0] = np.nan
    a[4, 4, 1] = np.nan
    out = patch_nan_emission_map(a)
    assert out.shape == a.shape
    assert np.all(np.isfinite(out))
    np.testing.assert_allclose(out[2, 2, 0], 1.0)


def test_beam_convolve_preserves_flux_and_smooths():
    img = np.zeros((64, 64))
    img[32, 32] = 100.0
    out = np.asarray(gaussian_beam_convolve(img, sigma_pix=3.0))
    np.testing.assert_allclose(out.sum(), 100.0, rtol=1e-4)
    assert out[32, 32] < 5.0
    assert out[32, 35] > 0.1
    # matches scipy's gaussian_filter away from edges
    from scipy.ndimage import gaussian_filter
    ref = gaussian_filter(img, sigma=3.0)
    np.testing.assert_allclose(out[20:45, 20:45], ref[20:45, 20:45],
                               atol=1e-5)


def test_fits_roundtrip(tmp_path):
    """Write a minimal FITS file by hand; read it back."""
    data = np.arange(12, dtype=">f4").reshape(3, 4)
    cards = [
        "SIMPLE  =                    T",
        "BITPIX  =                  -32",
        "NAXIS   =                    2",
        "NAXIS1  =                    4",
        "NAXIS2  =                    3",
        "BSCALE  =                  2.0",
        "BZERO   =                  1.0",
        "END",
    ]
    header = "".join(c.ljust(80) for c in cards).ljust(2880).encode()
    payload = data.tobytes()
    payload += b"\x00" * (-len(payload) % 2880)
    p = tmp_path / "test.fits"
    p.write_bytes(header + payload)

    img, hdr = read_fits_image(p)
    np.testing.assert_allclose(img, np.arange(12).reshape(3, 4) * 2.0 + 1.0)
    assert hdr["NAXIS1"] == 4

    m, x, y, meta = load_observation_map(str(p))
    assert m.shape == (3, 4)


def test_load_observation_npz(tmp_path):
    p = tmp_path / "obs.npz"
    np.savez(p, map=np.ones((8, 8)), x_coords=np.linspace(-1, 1, 8))
    m, x, y, meta = load_observation_map(str(p))
    assert m.shape == (8, 8)
    assert x is not None


def test_sdo_context_cli(tmp_path):
    """3-panel context figure from local FITS (plot_SDO_context.py parity
    given local inputs; fetching is out of scope)."""
    pytest.importorskip("matplotlib")
    from raytracinggrff_jax.cli.sdo_context import main
    from raytracinggrff_jax.utils.fits import write_fits_image

    rng = np.random.default_rng(3)
    write_fits_image(tmp_path / "a304.fits", rng.uniform(0, 255, (32, 32)))
    write_fits_image(tmp_path / "a171.fits", rng.uniform(0, 255, (32, 32)))
    write_fits_image(tmp_path / "hmi.fits",
                     rng.normal(0.0, 300.0, (32, 32)))
    out = tmp_path / "ctx.png"
    main(["--aia304", str(tmp_path / "a304.fits"),
          "--aia171", str(tmp_path / "a171.fits"),
          "--hmi", str(tmp_path / "hmi.fits"),
          "-d", "2025-06-08T20:00", "-o", str(out)])
    assert out.exists() and out.stat().st_size > 1000
