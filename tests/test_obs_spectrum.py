"""Observed-spectrum workflow: multi-band loading (FITS/HDF5/npz) and the
ROI spectra CLI (capability of ref script/pub/compare_ovro_Tb_spec.py)."""

import numpy as np
import pytest

from raytracinggrff_jax.constants import R_SUN_M
from raytracinggrff_jax.utils.fits import (read_fits_bintable,
                                           write_fits_image)
from raytracinggrff_jax.utils.obs import load_multiband_observation


def _obs_cube(nb=4, n=32):
    """Synthetic disk cube: band b is a uniform (b+1)*1e5 K disk."""
    img = np.zeros((nb, n, n))
    x = np.linspace(-2, 2, n)
    X, Y = np.meshgrid(x, x)
    disk = (X ** 2 + Y ** 2) < 1.0
    for b in range(nb):
        img[b][disk] = (b + 1) * 1e5
    freqs = 20e6 * (1 + np.arange(nb))
    return img, freqs, x


def _plate_cards(n, x):
    # CDELT in arcsec/pixel such that coords come out in the x grid above
    rsun = 945.0
    dx = (x[1] - x[0]) * rsun
    crpix = 1.0 - x[0] * rsun / dx
    return {"CDELT1": dx, "CDELT2": dx, "CRPIX1": crpix, "CRPIX2": crpix,
            "RSUN_OBS": rsun}


def test_fits_multiband_roundtrip(tmp_path):
    img, freqs, x = _obs_cube()
    path = tmp_path / "obs.fits"
    write_fits_image(path, img[None],  # (nstokes=1, nb, ny, nx)
                     header_cards=_plate_cards(32, x),
                     table_columns={"cfreqs": freqs})
    cols = read_fits_bintable(path)
    np.testing.assert_allclose(cols["cfreqs"], freqs)

    obs = load_multiband_observation(path)
    assert obs.img_k.shape == (4, 32, 32)
    np.testing.assert_allclose(obs.freqs_hz, freqs)
    np.testing.assert_allclose(obs.x_rsun, x, atol=1e-6)
    np.testing.assert_allclose(obs.img_k, img)


def test_hdf5_multiband(tmp_path):
    h5py = pytest.importorskip("h5py")
    img, freqs, x = _obs_cube()
    path = tmp_path / "obs.h5"
    with h5py.File(path, "w") as f:
        ds = f.create_dataset("image_I", data=img)
        for k, v in _plate_cards(32, x).items():
            ds.attrs[k] = v
        f.create_dataset("cfreqs", data=freqs)
    obs = load_multiband_observation(path)
    np.testing.assert_allclose(obs.freqs_hz, freqs)
    np.testing.assert_allclose(obs.img_k, img)
    np.testing.assert_allclose(obs.x_rsun, x, atol=1e-6)


def _write_model_sweep(out_dir, freqs_hz, n=24, tb0=4e5):
    x = np.linspace(-2, 2, n) * R_SUN_M
    X, Y = np.meshgrid(x / R_SUN_M, x / R_SUN_M)
    disk = (X ** 2 + Y ** 2) < 1.0
    for i, f in enumerate(freqs_hz):
        tb = np.zeros((n, n, 1))
        tb[disk, 0] = tb0 * (i + 1)
        np.savez(out_dir / f"raytrace_{i:02d}_{f/1e6:.3f}MHz.npz",
                 emission_cube=tb, frequencies_Hz=np.array([f]),
                 x_coords=x, y_coords=x)


def test_obs_spectrum_cli(tmp_path):
    from raytracinggrff_jax.cli.obs_spectrum import main

    freqs = np.array([20e6, 40e6, 60e6, 80e6])
    _write_model_sweep(tmp_path, freqs)
    img, ofreqs, x = _obs_cube()
    obs_path = tmp_path / "obs.npz"
    np.savez(obs_path, img_k=img, freqs_hz=ofreqs, x_rsun=x, y_rsun=x)

    out = tmp_path / "spec.png"
    rc = main(["-m", str(tmp_path), "-b", str(obs_path),
               "--roi=-0.3,0.3,-0.3,0.3,disk", "-o", str(out)])
    assert rc == 0 and out.exists()

    d = np.load(out.with_suffix(".npz"))
    np.testing.assert_allclose(d["disk_freq_model_hz"], freqs)
    # model disk ROI: exact uniform values
    np.testing.assert_allclose(d["disk_tb_model_k"],
                               4e5 * np.arange(1, 5), rtol=1e-6)
    # observed band 0 (1e5 K) is at the detection threshold -> dropped
    assert np.isnan(d["disk_tb_obs_k"][0])
    np.testing.assert_allclose(d["disk_tb_obs_k"][1:],
                               1e5 * np.arange(2, 5), rtol=1e-6)


def test_obs_spectrum_model_only(tmp_path):
    from raytracinggrff_jax.cli.obs_spectrum import main

    _write_model_sweep(tmp_path, np.array([30e6, 50e6]))
    out = tmp_path / "spec.png"
    rc = main(["-m", str(tmp_path), "-o", str(out)])
    assert rc == 0 and out.exists()


def test_fits_glob_observation(tmp_path):
    """A glob of single-band FITS maps stacks into one frequency-sorted
    observation cube (band centers from RESTFRQ)."""
    img, freqs, x = _obs_cube()
    for b in range(4)[::-1]:      # write out of order
        cards = dict(_plate_cards(32, x), RESTFRQ=freqs[b])
        write_fits_image(tmp_path / f"band{b}.fits", img[b], cards)
    obs = load_multiband_observation(str(tmp_path / "band*.fits"))
    np.testing.assert_allclose(obs.freqs_hz, freqs)
    np.testing.assert_allclose(obs.img_k, img)
    np.testing.assert_allclose(obs.x_rsun, x, atol=1e-6)
